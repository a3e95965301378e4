"""The plain reference: the same key-value semantics as the engine,
written in NumPy and plain Python, with none of the program's code."""
