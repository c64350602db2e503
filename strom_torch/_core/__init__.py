"""The native io_uring engine: its C++ source and build helper (compiled at
first use). A real package, so setuptools ships ``strom_core.cpp``."""
