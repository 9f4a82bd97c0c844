"""Data I/O: Gaussian map PLY files, scenes held in memory."""
