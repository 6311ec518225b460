"""Draft proposers for speculative decoding.

The port of ``skypilot_tpu/inference/speculative.py``. The continuous
engine's speculative mode turns one verify step into up to
``draft_k + 1`` emitted tokens: a draft proposes ``draft_k`` tokens
after the pending one, one verify step scores the whole window over the
paged pool, and the engine accepts the longest prefix that matches what
the target model samples at each position (sampling is a function of
(seed, position), so the accepted stream is the plain stream).

Drafts run on the host, on the serving-loop thread, between device
steps. Two proposers behind one interface:

* :class:`NGramDraft`: prompt lookup (the history's trailing n-gram's
  most recent earlier occurrence proposes what followed it) plus a
  corpus of finished completions. The default.
* :class:`ModelDraft`: greedy tokens of a (small) model over the
  history tail, through ``models/decode.generate``; it re-prefills on
  every call.

A proposer may return fewer than ``k`` tokens (none included): the
engine shrinks that slot's window, so a miss costs one ordinary step.
"""
from __future__ import annotations

from typing import Any, List, Sequence


class DraftModel:
    """Interface: propose up to ``k`` tokens continuing ``history``.

    ``history`` is the slot's whole visible stream: prompt, accepted
    generations, and the pending (sampled, not yet verified) token
    last."""

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        raise NotImplementedError


class NGramDraft(DraftModel):
    """Prompt lookup plus recent-completion retrieval.

    Lookup order: the slot's own history at the corpus's n-gram order
    (``max_ngram``) or the longest order the history allows; then the
    completion corpus (``observe``d finished streams, each
    ``max_ngram``-gram indexing the ``DRAFT_LEN`` tokens that followed
    it); then the history's shorter n-grams. So at equal order the
    history wins, and a corpus hit outranks a low-order history guess.
    The corpus holds at most ``corpus_entries`` n-grams and is cleared
    when an observation would overflow it (0 disables it).
    """

    DRAFT_LEN = 16  # continuation tokens remembered per indexed n-gram

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 corpus_entries: int = 0) -> None:
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(
                f'need 1 <= min_ngram <= max_ngram, got '
                f'({min_ngram}, {max_ngram})')
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.corpus_entries = corpus_entries
        self._index: dict = {}

    def observe(self, tokens: Sequence[int]) -> None:
        """Index a finished stream's n-grams (most recent wins)."""
        if not self.corpus_entries:
            return
        toks = list(tokens)
        n = self.max_ngram
        if len(self._index) + max(len(toks) - n, 0) > self.corpus_entries:
            self._index.clear()
        for i in range(len(toks) - n):
            cont = tuple(toks[i + n:i + n + self.DRAFT_LEN])
            if cont:
                self._index[tuple(toks[i:i + n])] = cont

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        hist = list(history)
        n_hist = len(hist)
        if k <= 0 or n_hist < self.min_ngram + 1:
            return []
        n_top = min(self.max_ngram, n_hist - 1)
        cont = self._history_lookup(hist, n_top, k)
        if cont:
            return cont
        if self._index and n_hist >= self.max_ngram:
            indexed = self._index.get(tuple(hist[-self.max_ngram:]))
            if indexed:
                return list(indexed[:k])
        for n in range(n_top - 1, self.min_ngram - 1, -1):
            cont = self._history_lookup(hist, n, k)
            if cont:
                return cont
        return []

    @staticmethod
    def _history_lookup(hist: List[int], n: int, k: int) -> List[int]:
        """What followed the most recent earlier occurrence of the
        trailing n-gram (never empty on a hit: i + n < len(hist))."""
        if n < 1:
            return []
        suffix = hist[-n:]
        for i in range(len(hist) - n - 1, -1, -1):
            if hist[i:i + n] == suffix:
                return hist[i + n:i + n + k]
        return []


class ModelDraft(DraftModel):
    """Greedy draft from a (small) model: ``models/decode.generate``
    over the last ``context_tokens`` of the history, on the device the
    draft's params live on. It pays a fresh prefill on every call."""

    def __init__(self, params: Any, cfg: Any,
                 context_tokens: int = 64) -> None:
        self.params = params
        self.cfg = cfg
        self.context_tokens = max(1, context_tokens)

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        if k <= 0 or not history:
            return []
        import torch

        from skypilot_tpu_torch.models import decode as decode_lib
        window = min(self.context_tokens, self.cfg.max_seq_len - k)
        ids = list(history)[-window:]
        device = self.params['embed']['embedding'].device
        tokens = torch.tensor([ids], dtype=torch.int32, device=device)
        lengths = torch.tensor([len(ids)], dtype=torch.int32,
                               device=device)
        with torch.no_grad():
            generated, gen_len = decode_lib.generate(
                self.params, tokens, lengths, self.cfg,
                max_new_tokens=k, temperature=0.0)
        return [int(t) for t in
                generated[0][:int(gen_len[0])].tolist()]
