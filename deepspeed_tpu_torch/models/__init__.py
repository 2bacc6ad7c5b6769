"""Model families of the port: Llama, GPT-2 and Mixtral."""
