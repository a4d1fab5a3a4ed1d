"""Dispatch, sync and build counting at the seams eager PyTorch has: the
dynamic twin of the static host-sync rule.

The counterpart of ``kubegpu_tpu/analysis/dispatchcount.py``, which
counts at the ``jax.jit`` seam. Eager PyTorch has no jit, so ``install()``
counts, per named :func:`section`:

* **dispatches**: operator calls seen by a
  ``torch.utils._python_dispatch.TorchDispatchMode``: aten operators,
  plus the port's own ``kgt::flash_fwd`` / ``kgt::flash_bwd``
  (``workload/kernels/flash.py``), each one host round trip into the
  dispatcher. What an operator runs inside is not counted again (the
  mode is off inside its own handler), so ``kgt.flash_fwd`` counts once.
  A per-operator tally (:func:`op_counts`) lets a caller read
  ``kgt.flash_fwd`` on its own. The mode is entered on the thread that
  calls ``install()``; the autograd engine carries it to the thread that
  runs a CUDA backward.
* **syncs**: calls of the host-sync rule's sinks on a tensor: ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, and ``bool()``/``int()``/
  ``float()`` (and ``__index__``) through the ``torch.Tensor`` dunders,
  counted by wrapping those methods. A tensor that ``.cpu()`` returned is
  on the host already, so a sink on it is not counted again
  (``x.cpu().numpy()`` is one sync). Counted at the methods, the same
  code gives the same count on the CPU as on the card (``.cpu()`` of a
  CPU tensor returns the tensor itself and dispatches no copy).
* **builds**: nvcc builds of ``workload/kernels/_build.py`` (a kernel
  library compiled at first use), the counterpart of the reference's
  compiles. :func:`counts`'s ``builds_total`` counts every build since
  the last :func:`reset`, inside a section or not.

The lifecycle contract is the reference's: ``install()`` is idempotent,
``uninstall()`` restores every wrapped method to the very object it
replaced and leaves the mode, importing this module imports no torch
(only ``install()`` does), ``section(name)`` nests with the innermost
section winning, and counts outside any section are not attributed.
Install and uninstall on one thread.

Eager PyTorch has no fused dispatch: a decode chunk dispatches every
operator of every step, so a chunk's dispatches are reported but not
budgeted. The budget is on syncs, the blocking device-to-host round
trips a chunk exists to amortise.

CLI::

    python -m kubegpu_tpu_torch.analysis.dispatchcount --smoke

runs a tiny fixed-shape step one readback a token (the per-token oracle)
and its chunked twin one readback a chunk, on the card when there is one
and else on the CPU, prints the reference's JSON keys with ``syncs``
where the reference counts dispatches per token, and exits 1 when a
section builds after warm-up or when the chunked section's syncs per
token exceed the reference's budget of 1.5/chunk. When torch does not
import it prints ``{"skipped": ...}`` and exits 0.
"""

from __future__ import annotations

import contextlib
import json
import threading
from typing import Any, Dict, Iterator, List, Optional

# the sinks of the host-sync rule, as torch.Tensor attributes
SYNC_METHODS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                "__float__", "__index__")
_KINDS = ("dispatches", "syncs", "builds")
_HOST_MARK = "_kgt_on_host"

_lock = threading.Lock()
_installed = False
_section_stack: List[str] = []
_sections: Dict[str, Dict[str, int]] = {}
_ops: Dict[str, Dict[str, int]] = {}
_builds_total = 0
_saved: Dict[str, Any] = {}     # torch.Tensor.__dict__ entries replaced
_mode: Any = None
_MISSING = object()


def installed() -> bool:
    return _installed


def reset() -> None:
    """Zero every counter (the counter stays installed)."""
    global _builds_total
    with _lock:
        _sections.clear()
        _ops.clear()
        _builds_total = 0


def _bump(kind: str, op: Optional[str] = None) -> None:
    with _lock:
        if not _section_stack:
            return
        sec = _section_stack[-1]
        _sections.setdefault(sec, dict.fromkeys(_KINDS, 0))[kind] += 1
        if op is not None:
            tally = _ops.setdefault(sec, {})
            tally[op] = tally.get(op, 0) + 1


def _on_build(name: str) -> None:
    global _builds_total
    with _lock:
        _builds_total += 1
    _bump("builds")


@contextlib.contextmanager
def section(name: str) -> Iterator[None]:
    """Attribute what runs inside the block to ``name``; nestable, the
    innermost section wins."""
    with _lock:
        _section_stack.append(name)
        _sections.setdefault(name, dict.fromkeys(_KINDS, 0))
    try:
        yield
    finally:
        with _lock:
            _section_stack.pop()


def _sync_wrapper(name: str, orig: Any) -> Any:
    def counted(self: Any, *args: Any, **kwargs: Any) -> Any:
        if not getattr(self, _HOST_MARK, False):
            _bump("syncs")
        out = orig(self, *args, **kwargs)
        if name == "cpu":
            # on the CPU this is ``self``: its later sinks read the host
            # copy on the card too
            setattr(out, _HOST_MARK, True)
        return out

    counted.__name__ = getattr(orig, "__name__", name)
    counted.__doc__ = getattr(orig, "__doc__", None)
    return counted


def install() -> None:
    """Wrap the sync methods, enter the counting dispatch mode and listen
    for kernel builds (idempotent)."""
    global _installed, _mode
    if _installed:
        return
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from kubegpu_tpu_torch.workload.kernels import _build

    class _CountingMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            _bump("dispatches", str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    for name in SYNC_METHODS:
        _saved[name] = torch.Tensor.__dict__.get(name, _MISSING)
        setattr(torch.Tensor, name,
                _sync_wrapper(name, getattr(torch.Tensor, name)))
    _build.build_listeners.append(_on_build)
    _mode = _CountingMode()
    _mode.__enter__()
    _installed = True


def uninstall() -> None:
    """Leave the mode and restore every wrapped method."""
    global _installed, _mode
    if not _installed:
        return
    import torch

    from kubegpu_tpu_torch.workload.kernels import _build

    _mode.__exit__(None, None, None)
    _mode = None
    _build.build_listeners.remove(_on_build)
    for name, orig in _saved.items():
        if orig is _MISSING:
            delattr(torch.Tensor, name)
        else:
            setattr(torch.Tensor, name, orig)
    _saved.clear()
    _installed = False


def counts() -> dict:
    """Snapshot: per-section dispatch/sync/build counts, the per-section
    operator tallies, and every build since the last reset."""
    with _lock:
        return {"sections": {n: dict(c) for n, c in _sections.items()},
                "ops": {n: dict(t) for n, t in _ops.items()},
                "builds_total": _builds_total}


def section_counts(name: str) -> Dict[str, int]:
    with _lock:
        return dict(_sections.get(name, dict.fromkeys(_KINDS, 0)))


def op_counts(name: str) -> Dict[str, int]:
    """``{operator: dispatches}`` of one section, e.g. ``"kgt.flash_fwd"``
    or ``"aten.mm"``."""
    with _lock:
        return dict(_ops.get(name, {}))


def _torch_missing() -> Optional[str]:
    """None when torch imports, else the reason (the smoke then skips)."""
    try:
        import torch  # noqa: F401
    except Exception as exc:  # noqa: BLE001 - any import failure = skip
        return f"{type(exc).__name__}: {exc}"
    return None


def smoke(tokens: int = 32, chunk: int = 16) -> int:
    """The per-token step and its chunked twin under the counter; prints
    the JSON keys and returns the exit code (module docstring)."""
    reason = _torch_missing()
    if reason is not None:
        print(json.dumps({"skipped": f"torch unusable: {reason}"}))
        return 0
    import torch

    chunk = max(1, min(chunk, tokens))  # a chunk can't exceed the workload
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")

    # a decode-shaped step on fixed [S] token/pos vectors and a carried
    # cache; the oracle reads each token back, the chunk reads back once
    def step(cache, tok, pos):
        cache = cache + tok[None, :].to(cache.dtype)
        return cache, (tok + 1) % 7, pos + 1

    def chunk_step(cache, tok, pos):
        toks = []
        for _ in range(chunk):
            cache, tok, pos = step(cache, tok, pos)
            toks.append(tok)
        return cache, tok, pos, torch.stack(toks, 1)

    cache = torch.zeros((4, 4), device=dev)
    tok = torch.zeros(4, dtype=torch.long, device=dev)
    pos = torch.zeros(4, dtype=torch.long, device=dev)
    out: list = []
    install()
    reset()
    try:
        with section("warmup"):
            cache, tok, pos = step(cache, tok, pos)
            cache, tok, pos, toks = chunk_step(cache, tok, pos)
            out.append(toks.tolist())
        with section("decode_fixed"):
            for _ in range(tokens):
                cache, tok, pos = step(cache, tok, pos)
                out.append(tok.tolist())
        with section("serve_fused"):
            done = 0
            while done < tokens:
                cache, tok, pos, toks = chunk_step(cache, tok, pos)
                out.append(toks.tolist())
                done += chunk
        dec = section_counts("decode_fixed")
        fused = section_counts("serve_fused")
        builds_total = counts()["builds_total"]
    finally:
        uninstall()
    spt = fused["syncs"] / tokens
    budget = 1.5 / chunk
    print(json.dumps({
        "decode_syncs_per_token": dec["syncs"] / tokens,
        "serve_syncs_per_token": spt,
        "serve_sync_budget_per_token": budget,
        "decode_dispatches_per_token": dec["dispatches"] / tokens,
        "serve_dispatches_per_token": fused["dispatches"] / tokens,
        "workload_builds_total": builds_total,
        "decode_fixed_builds": dec["builds"],
        "serve_fused_builds": fused["builds"],
        "device": str(dev)}))
    rc = 0
    for name, sec in (("decode", dec), ("fused serve", fused)):
        if sec["builds"] > 0:
            print(f"error: the fixed-shape {name} section built "
                  f"{sec['builds']} kernel librar(ies) after warm-up")
            rc = 1
    if spt > budget:
        print(f"error: serve_syncs_per_token {spt:.4f} exceeds the fused "
              f"budget {budget:.4f} (1/chunk + 50% slack): the chunk is not "
              "amortising its readbacks")
        rc = 1
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="dispatch/sync/build counter (device-boundary "
                    "analyzer, dynamic half)")
    parser.add_argument("--smoke", action="store_true",
                        help="run the per-token and chunked smoke and gate "
                             "on zero builds after warm-up and the "
                             "per-token sync budget")
    parser.add_argument("--tokens", type=int, default=32,
                        help="smoke decode-loop length (default 32)")
    parser.add_argument("--chunk", type=int, default=16,
                        help="chunk length (default 16)")
    args = parser.parse_args(argv)
    if args.smoke:
        return smoke(args.tokens, args.chunk)
    parser.error("nothing to do: pass --smoke")
    return 2


if __name__ == "__main__":
    import sys

    sys.exit(main())
