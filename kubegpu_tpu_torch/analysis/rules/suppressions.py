"""Unused-suppression audit: stale ``# analysis: disable=`` comments.

A suppression that no longer silences anything is itself a finding —
the invariant it waived may have been fixed (so the waiver should go),
or the rule moved and the comment now silences *nothing* while looking
like it silences *something*. Same stance as ruff's unused-``noqa``.

The engine marks every suppression with the rules it actually silenced
during this invocation; this rule (always run last) flags:

- a suppression naming a rule that RAN and silenced nothing,
- a suppression naming a rule that does not exist (typo'd waivers are
  silently-broken waivers),
- an ``all`` wildcard that silenced nothing (audited only when every
  rule ran — a partial ``--select`` cannot prove it dead).

Suppressions naming rules excluded by ``--select`` are left alone: the
evidence to audit them was not collected.

Rules with their own waiver grammar register usage evidence in
``ctx.waiver_audits`` (host-sync's ``# host-sync: allowed -- why``);
those waivers are audited here under the same gate: only when the
owning rule ran, a waiver covering no boundary call is stale.

The port's copy of ``kubegpu_tpu/analysis/rules/suppressions.py``.
"""

from __future__ import annotations

from typing import Iterator

from kubegpu_tpu_torch.analysis.engine import Context, Finding


class UnusedSuppression:
    name = "unused-suppression"
    description = ("`# analysis: disable=` comments that no longer "
                   "suppress anything (or name unknown rules) are "
                   "findings, like ruff's unused-noqa")

    def run(self, sources: list, ctx: Context) -> Iterator[Finding]:
        ran = set(ctx.ran_rules) - {self.name}
        known = set(ctx.known_rules)
        full_run = known - {self.name} <= ran
        for src in sources:
            for sup in src.suppressions:
                for rule in sorted(sup.rules):
                    if rule == self.name:
                        continue  # waiving this audit is always "used"
                    if rule == "all":
                        if full_run and not sup.used_rules:
                            yield Finding(
                                self.name, src.path, sup.line,
                                "suppression `all` no longer suppresses "
                                "anything; remove it")
                        continue
                    if rule not in known:
                        yield Finding(
                            self.name, src.path, sup.line,
                            f"suppression names unknown rule `{rule}` "
                            f"(typo? removed rule?); it silences nothing")
                        continue
                    if rule in ran and rule not in sup.used_rules:
                        yield Finding(
                            self.name, src.path, sup.line,
                            f"suppression of `{rule}` no longer "
                            f"suppresses anything here; remove it (the "
                            f"waived invariant may have been fixed)")
        for rule, audits in sorted(ctx.waiver_audits.items()):
            if rule not in ran:
                continue  # no evidence collected this invocation
            for audit in audits:
                if not audit["used"]:
                    yield Finding(
                        self.name, audit["path"], audit["line"],
                        f"`# {rule}: allowed` waiver no longer covers a "
                        "boundary call; remove it (the waived sync may "
                        "have been fixed)")
