"""Profiler ranges of the CKKS primitives: the reference's
`jax.named_scope("ckks.…")` names (`aesfhe_tpu/core/ops_impl.py:131-634`)
on the port's counterparts in `core/ops_impl.py`, as
`torch.profiler.record_function` ranges, so a trace splits device time by
primitive (`profile_round.scope_split`).  A range costs a few microseconds
of host time a call when no profiler runs, and nothing inside a CUDA
graph's replay."""
from __future__ import annotations

import functools

import torch

# ops_impl function -> range name
SCOPES = {
    "ct_tensor": "ckks.tensor",
    "ct_linear_combo": "ckks.linear_combo",
    "ct_linear_combo_dense": "ckks.linear_combo_dense",
    "ct_tensor_sum": "ckks.tensor_sum",
    "walsh_sub_bytes_core": "ckks.walsh_subbytes",
    "ct_automorphism": "ckks.automorphism",
    "ct_rescale": "ckks.rescale",
    "ct_rescale_pair": "ckks.rescale_pair",
    "mod_raise_core": "ckks.mod_raise",
    "ks_decompose": "ckks.ks_decompose",
    "ks_inner_and_moddown": "ckks.ks_inner_moddown",
    "hoisted_rotate": "ckks.hoisted_rotate",
    "keyswitch": "ckks.keyswitch",
}


def install(module) -> None:
    """Wrap each SCOPES function of `module` (ops_impl) in its range, once:
    calls through the module's attributes, its own included, see the
    wrapped function."""
    for fn_name, scope in SCOPES.items():
        fn = getattr(module, fn_name)
        if getattr(fn, "ckks_scope", None) == scope:
            continue

        def scoped(*args, _fn=fn, _scope=scope, **kwargs):
            with torch.profiler.record_function(_scope):
                return _fn(*args, **kwargs)

        functools.update_wrapper(scoped, fn)
        scoped.ckks_scope = scope
        setattr(module, fn_name, scoped)
