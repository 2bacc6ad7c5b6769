"""Host build helpers of the port."""
