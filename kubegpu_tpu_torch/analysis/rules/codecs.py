"""codec-pairing: every codec encoder has a decoder and a round trip.

The codecs ARE the wire protocol (``core/codec.py``): annotations
between the advertiser, the scheduler, and the CRI hook, and the binary
records the streaming transport frames carry. An encoder without a
decoder is a write nobody can read back — state that silently falls out
of the checkpoint/restore story (the API server is the only checkpoint)
or frames nobody can parse. Two naming conventions are enforced, each
both ways, and — when a tests directory is available — both halves of
every pair must appear in the port's codec round-trip tests
(``test_torch_codec*.py``; the ``test_codec*.py`` files test the reference's
codec, not this one):

* annotation codecs: ``<thing>_to_annotation`` / ``annotation_to_<thing>``
* binary wire codecs: ``encode_<record>`` / ``decode_<record>``

The port's copy of ``kubegpu_tpu/analysis/rules/codecs.py``.
"""

from __future__ import annotations

import ast
import glob
import os
import re
from typing import Iterator

from kubegpu_tpu_torch.analysis.engine import Context, Finding

# (encoder pattern, decoder pattern, decoder name template, encoder
# name template) per convention
_CONVENTIONS = (
    (re.compile(r"^(?P<stem>\w+)_to_annotation$"),
     re.compile(r"^annotation_to_(?P<stem>\w+)$"),
     "annotation_to_{stem}", "{stem}_to_annotation"),
    (re.compile(r"^encode_(?P<stem>\w+)$"),
     re.compile(r"^decode_(?P<stem>\w+)$"),
     "decode_{stem}", "encode_{stem}"),
)


class CodecPairing:
    name = "codec-pairing"
    description = ("every `<x>_to_annotation`/`encode_<x>` encoder needs "
                   "an `annotation_to_<x>`/`decode_<x>` decoder, and both "
                   "must appear in a round-trip test")

    def run(self, sources: list, ctx: Context) -> Iterator[Finding]:
        for src in sources:
            if src.name != "codec.py":
                continue
            test_idents = _codec_test_identifiers(ctx)
            for enc_re, dec_re, dec_tpl, enc_tpl in _CONVENTIONS:
                encoders: dict = {}
                decoders: dict = {}
                for node in src.tree.body:
                    if not isinstance(node, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                        continue
                    m = enc_re.match(node.name)
                    if m:
                        encoders[m.group("stem")] = node
                    m = dec_re.match(node.name)
                    if m:
                        decoders[m.group("stem")] = node
                for stem in sorted(encoders):
                    node = encoders[stem]
                    if stem not in decoders:
                        yield Finding(
                            self.name, src.path, node.lineno,
                            f"encoder `{node.name}` has no decoder "
                            f"`{dec_tpl.format(stem=stem)}` — state that "
                            f"cannot be read back falls out of the wire/"
                            f"checkpoint story")
                for stem in sorted(decoders):
                    node = decoders[stem]
                    if stem not in encoders:
                        yield Finding(
                            self.name, src.path, node.lineno,
                            f"decoder `{node.name}` has no encoder "
                            f"`{enc_tpl.format(stem=stem)}` — nothing "
                            f"produces what this reads")
                if test_idents is None:
                    continue  # no tests tree in scope: pairing check only
                for stem in sorted(set(encoders) & set(decoders)):
                    for node in (encoders[stem], decoders[stem]):
                        if node.name not in test_idents:
                            yield Finding(
                                self.name, src.path, node.lineno,
                                f"`{node.name}` never appears in the codec "
                                f"round-trip tests (test_torch_codec*.py) — an "
                                f"untested codec pair drifts")


def _codec_test_identifiers(ctx: Context) -> set | None:
    """Identifiers actually *referenced* (as names or attributes) in the
    codec round-trip tests. AST-level on purpose: a mention in a comment
    or docstring — or a longer name that merely contains the target as a
    substring — must not satisfy the tested-pair requirement."""
    if ctx.tests_dir is None or not os.path.isdir(ctx.tests_dir):
        return None
    idents: set = set()
    found = False
    for path in sorted(glob.glob(
            os.path.join(ctx.tests_dir, "test_torch_codec*.py"))):
        with open(path, encoding="utf-8") as fh:
            try:
                tree = ast.parse(fh.read(), filename=path)
            except SyntaxError:
                continue
        found = True
        for node in ast.walk(tree):
            if isinstance(node, ast.Name):
                idents.add(node.id)
            elif isinstance(node, ast.Attribute):
                idents.add(node.attr)
    return idents if found else None
