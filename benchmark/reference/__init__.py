"""The plain reference that decides `correct`: PyTorch and NumPy only, and
nothing of the measured program."""
