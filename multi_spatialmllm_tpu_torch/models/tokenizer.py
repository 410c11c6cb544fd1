"""Self-contained tokenizer for MultiSPA conversations (the port's copy of
multi_spatialmllm_tpu/models/tokenizer.py).

A deterministic word+byte tokenizer: a fixed special-token block, a
vocabulary of frequent words harvested from the template banks (their
strings are kept as data in `_vocab_templates.py`, so the ids are the JAX
package's), and UTF-8 byte fallback for everything else. Round-trippable.
`HFTokenizer` adapts a HuggingFace `tokenizer.json` to the same interface
(`encode`, `decode`, special ids).
"""

from __future__ import annotations

import re

PAD = "<pad>"
BOS = "<s>"
EOS = "</s>"
IMG_CONTEXT = "<IMG_CONTEXT>"
IMG_START = "<img>"
IMG_END = "</img>"
HUMAN = "<|human|>"
ASSISTANT = "<|assistant|>"

SPECIAL_TOKENS = (PAD, BOS, EOS, IMG_CONTEXT, IMG_START, IMG_END,
                  HUMAN, ASSISTANT)

_WORD_RE = re.compile(r"[A-Za-z]+|\d|[^\sA-Za-z\d]")


def _template_corpus() -> list[str]:
    """All template bank strings (deterministic vocabulary source)."""
    from ._vocab_templates import TEMPLATE_CORPUS

    return list(TEMPLATE_CORPUS)


class SpatialTokenizer:
    """Word-level vocab from the template banks + byte fallback."""

    def __init__(self):
        words: dict[str, int] = {}
        for text in _template_corpus():
            for tok in _WORD_RE.findall(text):
                words.setdefault(tok, 0)
                words[tok] += 1
        vocab_words = sorted(words, key=lambda w: (-words[w], w))

        self.tokens: list[str] = list(SPECIAL_TOKENS)
        self.tokens += [f"<byte_{i}>" for i in range(256)]
        self._byte_offset = len(SPECIAL_TOKENS)
        self.tokens += vocab_words
        self.token_to_id = {t: i for i, t in enumerate(self.tokens)}

        self.pad_id = self.token_to_id[PAD]
        self.bos_id = self.token_to_id[BOS]
        self.eos_id = self.token_to_id[EOS]
        self.img_context_id = self.token_to_id[IMG_CONTEXT]

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> list[int]:
        ids: list[int] = [self.bos_id] if add_bos else []
        pos = 0
        while pos < len(text):
            matched_special = None
            for sp in SPECIAL_TOKENS:
                if text.startswith(sp, pos):
                    matched_special = sp
                    break
            if matched_special:
                ids.append(self.token_to_id[matched_special])
                pos += len(matched_special)
                continue
            m = _WORD_RE.match(text, pos)
            if m and m.group() in self.token_to_id:
                ids.append(self.token_to_id[m.group()])
                pos = m.end()
            elif m:
                for b in m.group().encode("utf-8"):
                    ids.append(self._byte_offset + b)
                pos = m.end()
            else:  # whitespace and anything unmatched -> bytes
                for b in text[pos].encode("utf-8"):
                    ids.append(self._byte_offset + b)
                pos += 1
        if add_eos:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids) -> str:
        parts: list[str] = []
        byte_buf: list[int] = []

        def flush():
            if byte_buf:
                parts.append(bytes(byte_buf).decode("utf-8", "replace"))
                byte_buf.clear()

        # Whitespace always round-trips through byte tokens, so decoding is
        # the exact inverse of encoding: no spacing heuristics needed.
        for i in ids:
            i = int(i)
            tok = self.tokens[i]
            if tok.startswith("<byte_"):
                byte_buf.append(i - self._byte_offset)
                continue
            flush()
            if i in (self.pad_id, self.bos_id, self.eos_id):
                continue
            parts.append(tok)
        flush()
        return "".join(parts)


class HFTokenizer:
    """Adapter over a HuggingFace `tokenizers` JSON file (the format the
    InternVL-2 checkpoints ship as `tokenizer.json`) exposing the same
    interface as :class:`SpatialTokenizer`, so pretrained vocabularies
    drop into the runner/data paths unchanged.

    Special tokens are resolved by name; any missing from the vocabulary
    (e.g. `<IMG_CONTEXT>` on a base checkpoint) are added — mirroring how
    the reference's InternVL-2 stack extends the tokenizer before
    training (README.md:194-200).
    """

    def __init__(self, tokenizer_file: str):
        from tokenizers import Tokenizer

        self._tk = Tokenizer.from_file(tokenizer_file)
        missing = [t for t in SPECIAL_TOKENS
                   if self._tk.token_to_id(t) is None]
        if missing:
            from tokenizers import AddedToken

            self._tk.add_special_tokens(
                [AddedToken(t, special=True) for t in missing])
        self.pad_id = self._tk.token_to_id(PAD)
        self.bos_id = self._tk.token_to_id(BOS)
        self.eos_id = self._tk.token_to_id(EOS)
        self.img_context_id = self._tk.token_to_id(IMG_CONTEXT)

    @property
    def vocab_size(self) -> int:
        return self._tk.get_vocab_size(with_added_tokens=True)

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> list[int]:
        ids = self._tk.encode(text, add_special_tokens=False).ids
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids) -> str:
        keep = [int(i) for i in ids
                if int(i) not in (self.pad_id, self.bos_id, self.eos_id)]
        return self._tk.decode(keep, skip_special_tokens=False)


def load_tokenizer(path: str | None = None):
    """`tokenizer.json` path (or a checkpoint dir containing one) ->
    :class:`HFTokenizer`; None -> the self-contained
    :class:`SpatialTokenizer`."""
    import os

    if path is None:
        return SpatialTokenizer()
    if os.path.isdir(path):
        path = os.path.join(path, "tokenizer.json")
    return HFTokenizer(path)
