"""Text for the traffic, and the decoder's tokenizer.

The traffic's words come from the decoder's vocabulary itself, so a prompt of
n words is n tokens: word ``i`` is ``"w"`` and ``i`` in base 36. The
tokenizer maps such a word back to its id and any other word (a role marker,
a title, punctuation of the prompt's frame) to a hashed id. Decoding joins
words with spaces, so a served text splits back into its token ids, and the
number of tokens a stream served is the number of words it sent.
"""

from __future__ import annotations

import hashlib

import numpy as np

DIGITS = "0123456789abcdefghijklmnopqrstuvwxyz"


def word(i: int) -> str:
    s = ""
    while True:
        i, r = divmod(i, 36)
        s = DIGITS[r] + s
        if i == 0:
            return "w" + s


class WordTokenizer:
    """Word-level tokenizer over a vocabulary of ``vocab_size`` ids."""

    def __init__(self, vocab_size: int, eos_token_id: int):
        self.vocab_size = vocab_size
        self.eos_token_id = eos_token_id

    def token(self, w: str) -> int:
        if len(w) > 1 and w[0] == "w":
            try:
                i = int(w[1:], 36)
            except ValueError:
                i = -1
            if 0 <= i < self.vocab_size and word(i) == w:
                return i
        h = hashlib.blake2b(w.encode(), digest_size=8).digest()
        return int.from_bytes(h, "big") % self.vocab_size

    def encode(self, text: str) -> list[int]:
        return [self.token(w) for w in text.split()]

    def decode(self, ids) -> str:
        return " ".join(word(int(i)) for i in ids)


def draw_words(rng: np.random.Generator, n: int, lo: int, hi: int) -> str:
    """``n`` words drawn from ids in ``[lo, hi)``."""
    return " ".join(word(int(i)) for i in rng.integers(lo, hi, n))


def render(messages: list[dict]) -> str:
    """The prompt a chat template-less provider renders: one ``role:
    content`` line a message, then ``assistant:``."""
    return "\n".join(f"{m['role']}: {m['content']}" for m in messages) + "\nassistant:"
