"""The plain reference: float32 PyTorch, TF32 off, nothing of the program."""
