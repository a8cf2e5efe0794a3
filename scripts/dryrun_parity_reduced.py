"""The JAX package's dry-run at `configs.reduced` widths beside the
port's, cell by cell: per-device flops and their ratio. The reference
side runs here on the CPU (512 forced host devices), as the parity tests
run it; the port's records come from

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --reduced --out PORT_DIR

    PYTHONPATH=src python scripts/dryrun_parity_reduced.py PORT_DIR JAX_DIR

Reduced MoE cells (jamba, llama4, deepseek) fail in both packages (8
experts over a `model` axis of 16), and whisper's train and prefill
(its reduced position table is shorter than the frames).
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json                                      # noqa: E402

import repro.launch.dryrun as jax_dryrun        # noqa: E402
from repro.configs import LM_ARCHS, reduced     # noqa: E402
from repro.models.config import SHAPES          # noqa: E402


def main():
    port_dir, jax_dir = sys.argv[1:3]
    full = jax_dryrun.get_config
    jax_dryrun.get_config = lambda arch: reduced(full(arch))
    for mesh in ("single", "multi"):
        for arch in LM_ARCHS:
            for shape in SHAPES:
                tag = f"{arch}__{shape}__{mesh}"
                path = os.path.join(port_dir, tag + ".json")
                port = json.load(open(path)) if os.path.exists(path) else {}
                try:
                    ref = jax_dryrun.run_cell(arch, shape, mesh == "multi",
                                              out_dir=jax_dir)
                except Exception as e:      # the reduced MoE cells
                    print(f"{tag}: jax failed ({type(e).__name__}), port "
                          f"{port.get('status', 'missing')}")
                    continue
                if ref["status"] != "ok" or port.get("status") != "ok":
                    print(f"{tag}: jax {ref['status']}, port "
                          f"{port.get('status', 'missing')}")
                    continue
                p = port["roofline"]["per_device_flops"]
                j = ref["roofline"]["per_device_flops"]
                print(f"{tag}: port {p:.4e} jax {j:.4e} port/jax "
                      f"{p / j:.3f}")


if __name__ == "__main__":
    main()
