"""Worker for the 2-process jax.distributed CPU test (run by test_multiprocess).

Each process hosts 4 fake CPU devices; together they form the 8-way mesh. The
same shard_map kmerize program runs across both controllers, mirroring the
multi-host deployment (SURVEY.md section 4 item 4).
"""

import os
import sys


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]
    outdir = sys.argv[4]

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=nproc, process_id=pid)
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from zotpu.dist import mesh as M
    from zotpu.dist import shuffle

    D = len(jax.devices())
    assert D == 4 * nproc, D
    mesh = M.make_mesh()

    k = 17
    R, L = 32, 60
    rng = np.random.default_rng(42)  # same seed -> same global input everywhere
    codes_g = rng.integers(0, 4, (R, L)).astype(np.uint8)
    lengths_g = np.full(R, L, np.int32)

    step, cap_out = shuffle.make_kmerize_step(mesh, k, R // D, L,
                                              capacity_factor=6.0)
    sh2 = NamedSharding(mesh, P(M.AXIS, None))
    sh1 = NamedSharding(mesh, P(M.AXIS))
    codes = jax.make_array_from_callback((R, L), sh2, lambda i: codes_g[i])
    lengths = jax.make_array_from_callback((R,), sh1, lambda i: lengths_g[i])
    out = jax.block_until_ready(step(codes, lengths))
    uhi, ulo, counts, n_unique, overflow, routed = out

    # Collect this process's addressable shard rows.
    rows = {}
    for name, arr in (("uhi", uhi), ("ulo", ulo), ("counts", counts),
                      ("n", n_unique), ("ovf", overflow)):
        for s in arr.addressable_shards:
            d = s.index[0].start or 0
            rows.setdefault(d, {})[name] = np.asarray(s.data).reshape(-1)
    np.savez(os.path.join(outdir, f"proc{pid}.npz"),
             **{f"{name}_{d}": v for d, named in rows.items()
                for name, v in named.items()})
    print(f"proc {pid} ok, shards: {sorted(rows)}")


if __name__ == "__main__":
    main()
