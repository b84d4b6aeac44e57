"""Plain PyTorch and NumPy references for the benchmark's checks; they
import nothing of the program."""
