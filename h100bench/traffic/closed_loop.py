"""A closed loop of ``clients`` callers: each sends its next request the
moment its previous one completes (an offline batch job).  Prompts of
``prompt.min`` to ``prompt.max`` tokens and output budgets of
``output.min`` to ``output.max``, both uniform, stratified in blocks of
``block`` requests; every prompt is unique and every request greedy."""

from hb_draw import Spec, rng_for, strata, tokens, uniform_ppf


class Traffic:
    def __init__(self, params: dict, seed: int, vocab: int, start: float,
                 end: float, page: int):
        self.params, self.vocab = params, vocab
        self.start, self.end = start, end
        self.block = params.get("block", 64)
        self.body = rng_for(seed, "tokens")
        self.sizes = rng_for(seed, "sizes")
        self.pool = []

    def _next(self):
        if not self.pool:
            p, o, b = self.params["prompt"], self.params["output"], self.block
            lens = strata(self.sizes, b, uniform_ppf(p["min"], p["max"]))
            outs = strata(self.sizes, b, uniform_ppf(o["min"], o["max"]))
            self.pool = list(zip(lens, outs))
        n, out = self.pool.pop()
        return Spec(prompt=tokens(self.body, n, self.vocab), max_new=int(out))

    def initial(self):
        return [(self.start, self._next())
                for _ in range(self.params["clients"])]

    def after(self, spec, out_tokens, t_done):
        return [(t_done, self._next())] if t_done < self.end else []


def make(params, seed, vocab, start, end, page):
    return Traffic(params, seed, vocab, start, end, page)
