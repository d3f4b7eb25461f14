"""Subprocess worker for the 2-process multi-host test (test_parallel.py).

Each process: CPU platform with 2 local devices, jax.distributed over 2
processes -> a 4-device global (sp=2, dp=2) mesh spanning processes, renders
one chunk of the basic scene via the sharded path, and process 0 saves the
gathered framebuffer.  Run: python mh_worker.py <process_id> <out_npz>.
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)

import numpy as np  # noqa: E402


def main() -> None:
    pid = int(sys.argv[1])
    out_path = sys.argv[2]
    port = sys.argv[3] if len(sys.argv) > 3 else "12377"

    from raytracing_gpu.parallel import distributed

    distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=2, process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 4, jax.device_count()

    from raytracing_gpu.core.config import RenderSettings
    from raytracing_gpu.engine.render import render_linear
    from raytracing_gpu.models import scenes
    from raytracing_gpu.parallel.mesh import make_mesh
    from raytracing_gpu.parallel.render import make_sharded_chunk_fn

    sd = scenes.get("basic")
    settings = RenderSettings(image_width=64, aspect_ratio=1.0,
                              spp_per_chunk=4, num_chunks=1, max_depth=4,
                              ray_batch=512)
    mesh = make_mesh(n_sp=2)  # (sp=2, dp=2) spanning both processes
    chunk_fn = make_sharded_chunk_fn(mesh)
    linear = render_linear(sd.scene, sd.camera, settings, seed=3,
                           chunk_fn=chunk_fn)
    if distributed.is_coordinator():
        np.savez(out_path, linear=linear)


if __name__ == "__main__":
    main()
