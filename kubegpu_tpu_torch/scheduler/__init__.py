"""The GPU device-scheduler plugin."""
