"""Data I/O: Gaussian map PLY files."""
