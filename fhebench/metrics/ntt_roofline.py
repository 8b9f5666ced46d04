"""The NTT kernels' share of the card's memory roofline: the bytes the
window's `ntt_fwd`/`ntt_inv` calls need (each input word read once, each
output word written once, the frozen `reference/formulas.ntt_bytes`), over
their kernels' device time in the trace times the card's bandwidth, in %.

Left out, with the reason in a note, where the tallied launches differ
from `kernels.launch_counts()` or from the NTT kernels the trace holds."""
from fhebench.reference import formulas
from fhebench.roofline import share
from fhebench.tracing import Tally

KERNELS = r"ntt_(cluster16|cluster|block|cols|runs)"
NAMES = ("ntt_fwd", "ntt_inv")


def _account(args, kwargs):
    x = args[0]
    if not x.is_cuda:                  # the plain version, on the host
        return 0, 0
    out_dtype = kwargs.get("out_dtype", args[3] if len(args) > 3 else None)
    out_bytes = 8 if out_dtype is None else out_dtype.itemsize
    L, n = x.shape[-2], x.shape[-1]
    return (formulas.ntt_launches(n),
            formulas.ntt_bytes(x.numel() // (L * n), L, n, x.element_size(),
                               out_bytes))


TALLIES = [Tally("aesfhe_tpu_torch.core.ntt", name, name, _account)
           for name in NAMES]


def read(run):
    return share(run, "ntt_roofline", NAMES, KERNELS)
