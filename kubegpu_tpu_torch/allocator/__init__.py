"""The device-agnostic hierarchical group allocator (the port's copy of
``kubegpu_tpu/allocator``'s Python path): pure functions over the device
side's types, no devices and no I/O."""
