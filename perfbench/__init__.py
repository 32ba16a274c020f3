"""The benchmark of the PyTorch port (``universal_differential_equations_torch``)."""
