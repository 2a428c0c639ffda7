"""The benchmark's frozen arithmetic: the card's published peaks, each
kernel's operations and bytes, the model FLOPs of a step or a served
token, and the grouping of kernel names. Later changes to the program
leave these as they are, so a roofline share always reads the same
work."""

from .groups import KERNEL_GROUPS, kernel_group  # noqa: F401
from .peaks import BYTES_PER_S, PEAK_FLOPS, peaks_for  # noqa: F401
