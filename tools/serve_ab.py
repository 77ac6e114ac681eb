#!/usr/bin/env python3
"""The paged serving path of two checkouts side by side on one card.

    python3 tools/serve_ab.py ROOT TAG [REPS]

Serves, in the checkout at ROOT (its own ``chip_smoke.py`` and
``src/repro_torch``), the three models of ``chip_smoke.py``'s serving
phases, bf16 with weights from seed 0, through ``GenerateService`` on
their paged kernels: qwen3-1.7b and starcoder2-7b as published (K10) and
deepseek-v3-671b at full width cut to ``MLA_LAYERS`` layers (K11).  Each
serves workload (a) once to warm up, then workloads (a) and (b) of
``chip_smoke.SERVE_WORKLOADS`` REPS times each (3 by default).  Prints one
JSON line tagged TAG with each run's tokens per second and mean decode
round on the host and the device (the service's ``serve.decode_round_s``
/ ``serve.decode_device_s``).  Only the paged-attention kernels are
built.  Run two checkouts in turns (A, B, B, A), one process each, to
compare their host paths.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import sys


def main(root: pathlib.Path, tag: str, reps: int) -> None:
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    os.chdir(root)
    import numpy as np
    import torch
    import chip_smoke as cs
    import repro_torch  # noqa: F401  (sets TF32 off, as chip_smoke's main)
    from repro_torch import _build
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import kernel as pa_kernel
    from repro_torch.models import lm
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    _build.build([pa_kernel.SOURCE])
    pa_kernel.lib()
    cfgs = (get_config(cs.ARCH_SERVE), get_config(cs.ARCH_SC2),
            dataclasses.replace(get_config(cs.ARCH_MLA),
                                n_layers=cs.MLA_LAYERS))
    out = {}
    for cfg in cfgs:
        params = lm.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        runs = out[cfg.name] = {name: [] for name, *_ in cs.SERVE_WORKLOADS}
        plan = [cs.SERVE_WORKLOADS[0]] + list(cs.SERVE_WORKLOADS) * reps
        for i, (name, slots, plen, new) in enumerate(plan):
            work = cs.serve_workload(np, cfg.vocab, slots, plen, new)
            run = cs.run_service(torch, np, params, cfg, work, slots, plen,
                                 new, "auto")
            cs.check_served(np, cfg, name, run, work, "kernel")
            t = cs.serve_timings(np, name, run)
            del run
            if i:                              # the first run warms up
                runs[name].append({k: t[k] for k in (
                    "tok_per_s", "decode_round_host_ms_mean",
                    "decode_round_device_ms_mean")})
        del params
        cs.free_card(torch)
    print(f"[serve-ab] {tag} " + json.dumps(
        {"root": str(root), "runs": out}), flush=True)


if __name__ == "__main__":
    main(pathlib.Path(sys.argv[1]).resolve(), sys.argv[2],
         int(sys.argv[3]) if len(sys.argv) > 3 else 3)
