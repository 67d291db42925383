"""Library-wide matmul precision policy, on PyTorch's float32 knobs.

The JAX package runs every entry point under one matmul precision
(convex_dim_red_tpu/utils/precision.py).  The same policy strings map
onto PyTorch's float32 matmul settings:

====================  =================================  ==============
policy                ``set_float32_matmul_precision``   ``allow_tf32``
====================  =================================  ==============
'float32', 'highest'  'highest'                          False
'tensorfloat32'       'high'                             True
'bfloat16','fastest'  'medium'                           True
====================  =================================  ==============

'float32' is the default: the alternating solvers drive subproblems to
tolerances of 1e-4..1e-12, and every Hessian, gradient and cost flows
through a matmul.  Whether TF32 holds the audited cost at protocol
scale on a GPU is not measured yet, so it stays an opt-in.

The policy is applied around each public entry point by
:func:`apply_matmul_precision`, which restores the caller's settings on
exit.
"""

import contextlib
import functools

import torch

__all__ = [
    "get_matmul_precision",
    "set_matmul_precision",
    "matmul_precision_scope",
    "apply_matmul_precision",
]

_TORCH_PRECISION = {
    "float32": "highest",
    "highest": "highest",
    "tensorfloat32": "high",
    "bfloat16": "medium",
    "fastest": "medium",
}

_matmul_precision = "float32"


def get_matmul_precision():
    """The library's current matmul precision policy string."""
    return _matmul_precision


def set_matmul_precision(precision):
    """Set the matmul precision used by all library entry points.

    One of ``'float32'`` (alias ``'highest'``), ``'tensorfloat32'`` or
    ``'bfloat16'`` (alias ``'fastest'``).
    """
    global _matmul_precision
    if precision not in _TORCH_PRECISION:
        raise ValueError(
            "matmul precision must be one of %s, got %r"
            % (", ".join(_TORCH_PRECISION), precision))
    _matmul_precision = precision


@contextlib.contextmanager
def matmul_precision_scope():
    """Apply the library policy to PyTorch's float32 matmul settings
    for the duration of the block, then restore the previous ones."""
    prev_precision = torch.get_float32_matmul_precision()
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    target = _TORCH_PRECISION[_matmul_precision]
    torch.set_float32_matmul_precision(target)
    torch.backends.cuda.matmul.allow_tf32 = target != "highest"
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev_precision)
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


def apply_matmul_precision(fn):
    """Decorator: run ``fn`` under the library matmul precision
    policy."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with matmul_precision_scope():
            return fn(*args, **kwargs)

    return wrapper
