"""Plain references the benchmark judges the program against: plain
PyTorch and numpy, importing nothing of the program."""
