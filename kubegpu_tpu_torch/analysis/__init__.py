"""The port's checkers: the static rules (`engine.py` + `rules/`: the
control plane's lock, clock, exception, codec, charge, lifecycle,
metric, wire, race and hot-path rules, the device boundary's host-sync,
and the audit of every waiver; ``python -m kubegpu_tpu_torch.analysis``),
the dispatch/sync/build counter (`dispatchcount.py`) and the
deterministic interleaving explorer (`explore.py` + `schedules.py`),
which virtualizes the package's locks, condition waits and clocks,
enumerates thread schedules (bounded preemptions + sleep-set pruning)
and replays a failing one exactly.

Suppression::

    something_flagged()  # analysis: disable=<rule>  -- why it is fine

on the offending line or the line above it; ``# analysis:
disable-file=<rule>`` silences a rule for a whole file."""
