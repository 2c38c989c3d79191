"""Communication analysis of the sharded column/wavelength program.

Virtual CPU devices share host cores, so wall-clock 'scaling curves' on
them measure thread contention, not interconnect behaviour.  What CAN be measured
exactly is the communication the partitioner inserts: this script
compiles the batched MALI iteration on an (columns x wavelength) mesh,
parses the optimised HLO, and reports every collective with its payload
size.  Scaling efficiency on real chips is then bounded by
(collective bytes / iteration) / (interconnect bandwidth) vs compute time.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
         python scripts/comm_analysis.py
"""
import json
import os
import re
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

DTYPE_BYTES = {'f64': 8, 'f32': 4, 'bf16': 2, 'f16': 2, 's32': 4,
               'u32': 4, 's64': 8, 'u64': 8, 'pred': 1, 'c64': 8,
               'c128': 16, 's8': 1, 'u8': 1}


def collective_bytes(hloText):
    """Sum payload bytes of collective ops in optimised HLO text."""
    ops = {}
    pat = re.compile(
        r'=\s*([a-z0-9]+)\[([0-9,]*)\][^ ]*\s+'
        r'(all-reduce|all-gather|reduce-scatter|collective-permute|'
        r'all-to-all)\b')
    for m in pat.finditer(hloText):
        dt, shape, op = m.group(1), m.group(2), m.group(3)
        n = int(np.prod([int(s) for s in shape.split(',') if s] or [1]))
        nbytes = n * DTYPE_BYTES.get(dt, 8)
        ops.setdefault(op, []).append(nbytes)
    return ops


def main():
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)

    from scaling_bench import build_batch
    from lightweaver_tpu.parallel import make_mesh

    ndev = len(jax.devices())
    assert ndev >= 8, f'need 8 virtual devices, got {ndev}'

    report = {}
    # wavelength-axis shard counts must divide Nlam (546 here); the
    # production path pads the lambda grid to the mesh size instead.
    for name, (nc, nw) in {'columns8': (8, 1),
                           'columns4xlambda2': (4, 2)}.items():
        mesh = make_mesh(nColumns=nc, nWavelength=nw,
                         devices=jax.devices()[:8])
        batch = build_batch(16, nDepth=24, mesh=mesh)
        # compile the full (FS + Gamma) step exactly as iterate() runs it
        compiled = batch._iter_full.lower(batch.params).compile()
        ops = collective_bytes(compiled.as_text())
        summary = {k: {'count': len(v), 'total_bytes': int(sum(v)),
                       'max_bytes': int(max(v))} for k, v in ops.items()}
        report[name] = summary
        print(json.dumps({'mesh': name, 'collectives': summary}),
              flush=True)
    return report


if __name__ == '__main__':
    main()
