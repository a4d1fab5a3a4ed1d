"""The unused-suppression audit, for the host-sync waivers.

The port's copy of the part of
``kubegpu_tpu/analysis/rules/suppressions.py`` that its host-sync rule
needs: a justified ``# host-sync: allowed -- why`` waiver that covers no
sink is stale (the sync it waived may have been fixed, and the comment
now waives nothing while it looks as if it did). The rule that owns a
waiver grammar records each waiver's usage in ``ctx.waiver_audits``;
this audit, which the engine runs last, reports the unused ones, and
only for rules that ran in this invocation (without their evidence there
is no verdict).
"""

from __future__ import annotations

from typing import Iterator

from kubegpu_tpu_torch.analysis.engine import Context, Finding


class UnusedSuppression:
    name = "unused-suppression"
    description = ("a `# host-sync: allowed` waiver that no longer covers "
                   "a sink is stale, like ruff's unused-noqa")

    def run(self, sources: list, ctx: Context) -> Iterator[Finding]:
        for rule, audits in sorted(ctx.waiver_audits.items()):
            if rule not in ctx.ran_rules:
                continue
            for audit in audits:
                if not audit["used"]:
                    yield Finding(
                        self.name, audit["path"], audit["line"],
                        f"`# {rule}: allowed` waiver no longer covers a "
                        "boundary call; remove it (the waived sync may "
                        "have been fixed)")
