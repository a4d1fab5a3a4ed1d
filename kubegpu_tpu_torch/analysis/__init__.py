"""The port's checkers: the device-boundary ones (the host-sync rule and
the dispatch/sync/build counter) and the deterministic interleaving
explorer (`explore.py` + `schedules.py`), which virtualizes the package's
locks, condition waits and clocks, enumerates thread schedules (bounded
preemptions + sleep-set pruning) and replays a failing one exactly."""
