"""The port's own copy of the device side's data model: types, the GPU
resource grammar and the JSON annotation codec."""
