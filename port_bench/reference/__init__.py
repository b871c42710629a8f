"""The plain reference: PyTorch only, nothing of the program."""
