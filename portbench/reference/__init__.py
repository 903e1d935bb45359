"""The plain reference that decides ``correct``: the quantized Laplacian
and its Poisson solve (quantized.py), the initial-state map (initial.py),
the midpoint schemes' shared loop (scheme.py) and each scheme in a file
of its own named as configurations name it (isomp.py, magmp.py), in
plain PyTorch and NumPy.  Nothing here imports the program under test."""
