"""Models of the port: attention and Mamba2 blocks, their assembly."""
