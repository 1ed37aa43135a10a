"""The benchmark's plain reference: NumPy, SciPy and plain PyTorch, written
from the published descriptions.  It imports nothing of the program under
test and takes nothing the program made."""
