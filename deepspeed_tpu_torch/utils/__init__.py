"""Host helpers of the port: native builds and the collective log."""
