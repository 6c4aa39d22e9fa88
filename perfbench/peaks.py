"""The NVIDIA H100's published peaks (SXM part, dense, at its 700 W power
limit; NVIDIA's data sheet), the yardstick of every share of a peak or of
a roofline here.  A card set below 700 W reaches less; ``card()`` reads the
name and the power limit to print beside every such share."""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {
    "float32": 67e12,     # FMA pipes, no tensor cores (TF32 off)
    "bfloat16": 989e12,
}


def least_seconds(flops, nbytes, dtype):
    """The least time a kernel can take: the larger of its operations over
    the peak of ``dtype`` and its bytes over the memory's bandwidth."""
    return max(flops / FLOPS_PER_S[dtype], nbytes / HBM_BYTES_PER_S)


def card():
    """``name, power.limit`` of the first card as nvidia-smi gives them,
    or what went wrong."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    lines = proc.stdout.strip().splitlines()
    return lines[0] if proc.returncode == 0 and lines else \
        f"nvidia-smi failed: {proc.stderr.strip()}"
