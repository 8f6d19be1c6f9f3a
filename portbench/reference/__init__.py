"""The plain float32 reference that decides ``correct``: plain PyTorch
and numpy, importing nothing of the program."""
