"""The benchmark's tokenizer: word-level ids over the traffic bank's words,
UTF-8 byte fallback, and the chat format's special strings as single ids.

The system takes its tokenizer from outside (InternVL ships InternLM2's),
so the benchmark hands the same tokenizer object to the program and to
the reference: both then work from the same ids. It covers the model's
whole vocabulary on the way out: an id past the words decodes as
`<t{id}>`, as a model with random weights emits any id.
"""

from __future__ import annotations

import re

# the chat format's strings, in the order that gives IMG_CONTEXT id 3
PAD, BOS, EOS = "<pad>", "<s>", "</s>"
IMG_CONTEXT, IMG_START, IMG_END = "<IMG_CONTEXT>", "<img>", "</img>"
HUMAN, ASSISTANT = "<|human|>", "<|assistant|>"
SPECIALS = (PAD, BOS, EOS, IMG_CONTEXT, IMG_START, IMG_END, HUMAN, ASSISTANT)

_WORD = re.compile(r"[A-Za-z]+|\d|[^\sA-Za-z\d]")


class BenchTokenizer:
    """`encode(text) -> ids`, `decode(ids) -> text` and the special ids,
    the interface the program's data and serving code call."""

    def __init__(self, corpus: list[str]):
        counts: dict[str, int] = {}
        for text in corpus:
            for w in _WORD.findall(text):
                counts[w] = counts.get(w, 0) + 1
        words = sorted(counts, key=lambda w: (-counts[w], w))
        self.tokens = list(SPECIALS) + [f"<byte_{i}>" for i in range(256)]
        self._byte0 = len(SPECIALS)
        self.tokens += words
        self.ids = {t: i for i, t in enumerate(self.tokens)}
        self.pad_id, self.bos_id, self.eos_id = (self.ids[t] for t in
                                                 (PAD, BOS, EOS))
        self.img_context_id = self.ids[IMG_CONTEXT]

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    def encode(self, text: str) -> list[int]:
        out = []
        pos = 0
        while pos < len(text):
            sp = next((s for s in SPECIALS if text.startswith(s, pos)), None)
            if sp is not None:
                out.append(self.ids[sp])
                pos += len(sp)
                continue
            m = _WORD.match(text, pos)
            piece = m.group() if m else text[pos]
            if m and piece in self.ids:
                out.append(self.ids[piece])
            else:
                out.extend(self._byte0 + b for b in piece.encode("utf-8"))
            pos += len(piece)
        return out

    def decode(self, ids) -> str:
        parts, raw = [], bytearray()
        for i in map(int, ids):
            if self._byte0 <= i < self._byte0 + 256:
                raw.append(i - self._byte0)
                continue
            if raw:
                parts.append(raw.decode("utf-8", "replace"))
                raw.clear()
            if i in (self.pad_id, self.bos_id, self.eos_id):
                continue
            parts.append(self.tokens[i] if i < len(self.tokens) else f"<t{i}>")
        if raw:
            parts.append(raw.decode("utf-8", "replace"))
        return "".join(parts)
