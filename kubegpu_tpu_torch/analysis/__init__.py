"""The port's device-boundary checkers: the host-sync rule and the
dispatch/sync/build counter."""
