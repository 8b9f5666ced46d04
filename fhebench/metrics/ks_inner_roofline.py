"""`ks_inner`'s share of the card's memory roofline: the bytes the window's
key-switch inner products need (the frozen
`reference/formulas.ks_inner_bytes` of each call's [digits, rows, N]), over
the kernel's device time in the trace times the card's bandwidth, in %.

Left out, with the reason in a note, where the tallied launches differ
from `kernels.launch_counts()` or from the kernels the trace holds."""
from fhebench.reference import formulas
from fhebench.roofline import share
from fhebench.tracing import Tally

KERNELS = r"ks_inner_kernel"
NAMES = ("ks_inner",)


def _account(args, kwargs):
    if not args[0].is_cuda:            # the plain version, on the host
        return 0, 0
    J, M, N = args[0].shape
    return 1, formulas.ks_inner_bytes(J, M, N)


TALLIES = [Tally("aesfhe_tpu_torch.core.ks_inner", "ks_inner", "ks_inner",
                 _account)]


def read(run):
    return share(run, "ks_inner_roofline", NAMES, KERNELS)
