"""Host utilities: the C++ host ops (ctypes)."""
