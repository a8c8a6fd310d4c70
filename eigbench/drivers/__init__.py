"""Drivers: one traffic mix's solve each, loaded by path from the name in
``traffic/<mix>.json``.

A driver module gives:

``setup(ctx)``
    Makes the cell's inputs on ``ctx.device`` from ``ctx.seed`` and the
    program's objects built on them; returns a state object.
``inputs(state, i, stream)``
    The inputs of solve ``i`` of ``stream`` ("warm" or "timed"), made
    from the seed: a start vector or block, a coupling.
``solve(state, inp, spans)``
    One whole call of the cell's entry, eigenpair and derivatives, on
    the program; the harness synchronizes after it.  With ``spans`` (a
    dict, traced runs only) it records its own synced spans in ms.
``digest(state, inp, out)``
    What the check compares, on the host.
``release(state)``
    Drops the program's objects; the inputs stay for the reference.
``reference(state, inp, precision)``
    The same digest from the plain reference, in "f64", or in the
    control's precision.
``compare(got, ref)``
    ``{number: value}``, each held to the mix's ``limits``.
"""
