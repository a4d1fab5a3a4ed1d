"""The node side of the port: NVIDIA GPU discovery (NVML through
``ctypes``), canned inventories for tests, and the device manager that
advertises cards and hands them to containers."""
