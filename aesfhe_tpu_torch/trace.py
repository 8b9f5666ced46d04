"""The port's profiler ranges, every one of them opened here.

`span(name)` is a `torch.profiler.record_function` range while a profiler
records (`torch.autograd._profiler_enabled()`), so it sits on the
profiler's clock beside the CUDA activity and an idle gap of the card can
be put down to the range open on the host; with no profiler it is one
shared no-op context, which costs the flag check alone.  A range opens
nothing inside a CUDA graph's replay: the bootstrap times its phases there
with events (`bootstrap._PhaseTimer`).

Every name starts with `ckks.`, which a trace reader tells from a device
operation by (a range's annotation on the card's timeline is no kernel):

    ckks.aes.round       one AES round (`run_full_aes.run_round`, the loop
                         bodies of both pipelines' encrypt/decrypt_rounds)
    ckks.aes.ark         AddRoundKey (and the zeta entry's input cleanse)
    ckks.aes.sub_bytes   SubBytes
    ckks.aes.shift_mix   ShiftRows, MixColumns and the cleanse after them
    ckks.aes.refresh     a pipeline's refresh when it refreshes
    ckks.boot            one bootstrap, eager or a graph replay
    ckks.boot.cts        ModRaise through the conjugation split (eager)
    ckks.boot.evalmod    both EvalMod halves (eager)
    ckks.boot.stc        SlotToCoeff (eager)
    SCOPES' names        the CKKS primitives of `core/ops_impl`
"""
from __future__ import annotations

import contextlib
import functools

import torch

_OFF = contextlib.nullcontext()

# range name -> the ops_impl functions it wraps: the reference's
# jax.named_scope names (`aesfhe_tpu/core/ops_impl.py:131-634`), then the
# elementwise ops the reference leaves unnamed
SCOPES = {
    "ckks.tensor": ("ct_tensor",),
    "ckks.linear_combo": ("ct_linear_combo",),
    "ckks.linear_combo_dense": ("ct_linear_combo_dense",),
    "ckks.tensor_sum": ("ct_tensor_sum",),
    "ckks.walsh_subbytes": ("walsh_sub_bytes_core",),
    "ckks.automorphism": ("ct_automorphism",),
    "ckks.rescale": ("ct_rescale",),
    "ckks.rescale_pair": ("ct_rescale_pair",),
    "ckks.mod_raise": ("mod_raise_core",),
    "ckks.ks_decompose": ("ks_decompose",),
    "ckks.ks_inner_moddown": ("ks_inner_and_moddown",),
    "ckks.hoisted_rotate": ("hoisted_rotate",),
    "ckks.keyswitch": ("keyswitch",),
    "ckks.add": ("ct_add", "ct_sub", "ct_negate"),
    "ckks.mul_pt": ("ct_mul_dense_pt", "ct_mul_scalar_pt"),
    "ckks.add_scalar": ("ct_add_scalar_pt",),
}


def on() -> bool:
    """Whether a profiler records, and so whether a span is a range."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """The range `name` while a profiler records, else a shared no-op."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def install(module) -> None:
    """Wrap each SCOPES function of `module` (ops_impl) in its span, once:
    calls through the module's attributes, its own included, see the
    wrapped function."""
    for scope, fn_names in SCOPES.items():
        for fn_name in fn_names:
            fn = getattr(module, fn_name)
            if getattr(fn, "ckks_scope", None) == scope:
                continue

            def scoped(*args, _fn=fn, _scope=scope, **kwargs):
                with span(_scope):
                    return _fn(*args, **kwargs)

            functools.update_wrapper(scoped, fn)
            scoped.ckks_scope = scope
            setattr(module, fn_name, scoped)
