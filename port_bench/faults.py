"""Faults planted in the program underneath a run, for the tests that
see ``correct`` come out false and for the fault readings on the card
(``python3 -m port_bench.control --fault <name>``).

Each cell's faults are data, in ``port_bench/proofs/<cell>.json``:

    {"control": "<the number the control fails>",
     "faults": {"<name>": {"at": "calls" | "setup",
                           "target": "<module>:<attribute>",
                           "breaker": "<module>:<function>",
                           "args": {...}, "catches": "<number>"}}}

``target`` is the program's function that is replaced, inside the
window's calls or inside set-up (a transform cell's fit), by
``breaker(real, **args)``; ``catches`` is the number meant to catch it.
The breakers below cover the faults a cell on one card can have (it has
no exchange between cards to leave out); a later cell may name a
breaker of a module of its own.
"""

import contextlib
import importlib
from pathlib import Path

import torch

from port_bench import harness


def unchanged(real):
    """The weights step returns its state unchanged."""
    def broken(A, B, X0, **kw):
        return X0.clone()
    return broken


def dictionary_unchanged(real):
    """The dictionary step (the SPG onto row-stochastic matrices)
    returns its state unchanged; other SPG solves run."""
    def broken(matvec, B, x0, project, *args, **kw):
        if getattr(project, "__name__", "") == "simplex_project_rows":
            return x0.clone()
        return real(matvec, B, x0, project, *args, **kw)
    return broken


def half(real):
    """Half of the rows left out of the weights step."""
    def broken(A, B, X0, **kw):
        h = B.shape[-2] // 2
        top = real(A, B[..., :h, :].contiguous(),
                   X0[..., :h, :].contiguous(), **kw)
        return torch.cat([top, X0[..., h:, :]], dim=-2)
    return broken


def rolled(real):
    """Each answer altered where it is produced: the weights' rows
    handed out one place off."""
    def broken(A, B, X0, **kw):
        return torch.roll(real(A, B, X0, **kw), 1, dims=-2)
    return broken


def half_cost(real):
    """The cost's mean taken over half of the rows (``_aa_iter_cost``'s
    residual form)."""
    def broken(X_loc, Z_loc, C, alpha, CK, CKCt, trace_K, sh):
        h = X_loc.shape[0] // 2
        CX = C @ X_loc
        resid = Z_loc[:, :h] @ (alpha[:, :, None] * CX) - X_loc[:h]
        return 0.5 * torch.sum(resid * resid, dim=(1, 2)) / h
    return broken


def scaled(real, key, by):
    """An answer altered where it is produced: ``out[key]`` times
    ``by``."""
    def broken(*args, **kw):
        out = real(*args, **kw)
        out[key] = out[key] * by
        return out
    return broken


def proofs(cell, files=harness.HERE):
    """A cell's proofs file: the number its control fails and its
    faults."""
    return harness.load_json(Path(files) / "proofs" / (cell + ".json"))


def _attribute(path):
    module, name = path.split(":")
    return importlib.import_module(module), name


@contextlib.contextmanager
def patched(spec):
    module, name = _attribute(spec["target"])
    breaker_module, breaker = _attribute(spec["breaker"])
    real = getattr(module, name)
    setattr(module, name, getattr(breaker_module, breaker)(
        real, **spec.get("args", {})))
    try:
        yield
    finally:
        setattr(module, name, real)


def hook(spec):
    """The ``entry_hook`` that plants one fault: in the window's calls
    (set-up stays sound) or in set-up's ``warm``."""
    method = {"calls": "call", "setup": "warm"}[spec["at"]]

    def plant(entry):
        real = getattr(entry, method)

        def broken():
            with patched(spec):
                return real()
        setattr(entry, method, broken)
    return plant


def hook_for(cell, fault, files=harness.HERE):
    """The ``entry_hook`` that plants ``fault`` in ``cell``, and the
    number meant to catch it."""
    spec = proofs(cell, files)["faults"][fault]
    return hook(spec), spec["catches"]
