"""The control of the comparison: the program's outputs at the next
lower precision than the configuration states (10-bit samples kept to
8 bits, 8-bit samples to 7), which the comparison must judge not
correct. Used by the card test in tests/, never by a benchmark run."""
from __future__ import annotations


def lower_precision(bit_depth):
    """A hook for the harness's `output_hook`: each output with the low
    bits of every sample cleared, 10 and 12 bits down to 8, 8 to 7."""
    drop = bit_depth - 8 if bit_depth > 8 else 1
    mask = ~((1 << drop) - 1)

    def hook(out):
        return out & mask
    return hook
