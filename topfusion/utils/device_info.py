"""Device / mesh introspection banner.

The analogue of the reference's CUDA device management + info printers
(reference: tfusion/src/core.cpp:8-200 printCudaDeviceInfo /
printShortCudaDeviceInfo / setDevice / checkIfPreFermiGPU).  Device
*selection* is the runtime's job under JAX; what remains useful is a
human-readable banner and mesh summary.
"""

from __future__ import annotations

from typing import Optional

import jax


def device_banner(verbose: bool = False) -> str:
    """One line per device + backend summary (print at startup)."""
    lines = []
    devs = jax.devices()
    lines.append(
        f"jax {jax.__version__} — backend '{devs[0].platform}', "
        f"{len(devs)} device(s), {jax.process_count()} process(es)"
    )
    for d in devs:
        desc = f"  [{d.id}] {d.device_kind}"
        if verbose:
            desc += f" (process {d.process_index}, {d!r})"
        lines.append(desc)
    return "\n".join(lines)


def mesh_banner(mesh) -> str:
    """Summarize a jax.sharding.Mesh layout."""
    axes = ", ".join(f"{k}={v}" for k, v in mesh.shape.items())
    return f"mesh axes: {axes} over {mesh.devices.size} device(s)"


def print_device_info(verbose: bool = False) -> None:
    print(device_banner(verbose))
