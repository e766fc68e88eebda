"""Host-side native code of the port: the delta codec (``codec.cpp``),
built with ``g++ -lz`` at first use and bound with ctypes."""
