"""Published peaks of the card the cells run on.

One NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet, dense rates, at its
700 W limit): 67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s of
HBM3. 32-bit integer operations (add, compare, AND/OR/XOR) issue at 64
results a clock on each of the 132 SMs (the CUDA C++ Programming
Guide's throughput table for compute capability 9.0) at the 1.98 GHz
boost clock the fp32 figure assumes: 16.7 T op/s. A card set below
700 W runs slower; every share is printed beside the card's power
limit.
"""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_flops": 67e12,
        "int32_ops": 64 * 132 * 1.98e9,
        "hbm_bytes_s": 3.35e12,
    },
}


def peaks_for(device_name: str) -> dict:
    """The peaks of `device_name`; a card not in the table has none, and
    its roofline shares are not reported."""
    return PEAKS.get(device_name, {})
