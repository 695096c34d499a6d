"""Model math of the port: the paged decoder stack on torch tensors."""
