"""Host-side native code: the C++ libraries the port builds at first use."""
