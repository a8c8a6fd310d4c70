"""backward_ms: the IFT rule's backward (``ops/eigh.py``), the harness's
own span around ``torch.autograd.grad``, synchronized on both sides, in
ms, averaged over the traced solves."""


def read(ctx):
    times = [s["backward_ms"] for s in ctx.spans if "backward_ms" in s]
    return sum(times) / len(times) if times else None
