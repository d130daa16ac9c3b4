"""Faults planted underneath the timed path, for the check's own tests
and for reading them on the card (``control.py --fault <name>``).  Each
replaces one method of the port's shard engine:

- ``altered_token``: the first row of every pick is moved to the next
  token id, where the token is produced;
- ``pages_unchanged``: a decode step leaves the KV pages as they were
  (the slots it wrote are put back);
- ``half_batch``: the second half of a decode batch gets the mean of the
  first half's logits in place of its own.
"""

from __future__ import annotations


def _altered_token(orig):
    def altered(self, logits, sampf, sampi, spos):
        toks, lps = orig(self, logits, sampf, sampi, spos)
        toks = toks.copy()
        toks[0] = (toks[0] + 1) % logits.shape[-1]
        return toks, lps
    return altered


def _pages_unchanged(orig):
    def frozen(self, *args):
        wr_page, wr_slot = args[5], args[6]
        k = self.k_pages[:, wr_page, wr_slot].clone()
        v = self.v_pages[:, wr_page, wr_slot].clone()
        out = orig(self, *args)
        self.k_pages[:, wr_page, wr_slot] = k
        self.v_pages[:, wr_page, wr_slot] = v
        return out
    return frozen


def _half_batch(orig):
    def half(self, batch_seqs):
        logits, ctx = orig(self, batch_seqs)
        n = len(batch_seqs)
        logits = logits.clone()
        logits[n // 2:n] = logits[:n - n // 2].mean(dim=0)
        return logits, ctx
    return half


FAULTS = {"altered_token": ("_sample", _altered_token),
          "pages_unchanged": ("_paged_decode_step", _pages_unchanged),
          "half_batch": ("_decode_logits", _half_batch)}


def plant(name: str, set_attr=setattr) -> None:
    """Plant the fault ``name`` in the port's shard engine, through
    ``set_attr`` (a test's ``monkeypatch.setattr`` undoes it)."""
    from repro_torch.serving import engine
    method, make = FAULTS[name]
    cls = engine._ShardEngine
    set_attr(cls, method, make(getattr(cls, method)))
