"""The port's control plane: its API server (the store and arbiter, the
write-ahead log, the front door) and the client, on the JSON and stream
wires."""
