"""The plain float32 reference the benchmark judges the program by."""
