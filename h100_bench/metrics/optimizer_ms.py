"""Host ms per step inside torch.optim's own ``Optimizer.step#<class>.step``
range."""


def read(run):
    t = run.trace
    spans = [h for h in t.host if h.name.startswith("Optimizer.step#")]
    return 1e3 * sum(h.end - h.start for h in spans) / 1e9 / t.units if spans else None
