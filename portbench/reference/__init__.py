"""The plain reference of the benchmark: the ``ber`` step of the
configurations in plain PyTorch and numpy, on its own copy of the code
tables. It imports nothing of the program under test."""
