"""The plain reference of the enhancement path: plain PyTorch, float32 with TF32 off, importing nothing of the program."""
