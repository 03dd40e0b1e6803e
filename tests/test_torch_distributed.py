"""The port's two-process path against the JAX package's single-process
block, on the CPU (the counterpart of tests/test_distributed.py).

Two worker processes of the port start a gloo process group with
``init_distributed`` (the JAX package's environment names), build
``pod_mesh`` over four virtual CPU shards each (q = 2 processes, r = 4),
and compute the tiles of the devices they own of one sharded block; the
tiles are gathered on the host over gloo (parallel/dists._fetch), so both
ranks see the whole block. It must equal the port's single-process block
bit for bit and the JAX package's within tests/test_parallel.py's mesh
tolerance (tests/test_torch_parallel.py says why). Each worker has its
own timeout, a free port and destroys its process group.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_TOL = dict(atol=1e-4)  # tests/test_parallel.py's
WORKER_TIMEOUT = 120  # seconds, each

WORKER = textwrap.dedent("""
    import os, sys
    rank = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
    out_npz = sys.argv[4]
    sys.path.insert(0, {repo!r})
    sys.path.insert(0, os.path.join({repo!r}, "tests"))
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from poppunk_tpu_torch.parallel import init_distributed, is_primary
    from poppunk_tpu_torch.parallel import pod_mesh, sharded_pairwise_block
    from poppunk_tpu_torch.parallel.mesh import process_count
    from poppunk_tpu_torch.ops.distances import plane_geometry

    # tests/test_parallel.py's planes, drawn here: the workers load
    # neither jax nor the JAX package
    KLIST = (15, 18, 21); SS64 = 16; BBITS = 4
    _, wp, _ = plane_geometry(SS64, BBITS)

    def synth(n, seed):
        rng = np.random.default_rng(seed)
        w32 = 2 * SS64
        p = np.zeros((n, len(KLIST), BBITS, wp), dtype=np.uint32)
        p[..., :w32] = rng.integers(0, 2**32, (n, len(KLIST), BBITS, w32),
                                    dtype=np.uint32)
        return (p, rng.integers(1_000_000, 2_000_000, n).astype(np.int32),
                rng.dirichlet(np.ones(4), n).astype(np.float32))

    assert init_distributed(coordinator_address="localhost:" + port,
                            num_processes=nproc, process_id=rank)
    try:
        assert process_count() == nproc
        mesh = pod_mesh(devices=[torch.device("cpu")] * 4)
        # one query shard per process, r inside each process's devices
        assert mesh.shape == {{"q": nproc, "r": 4}}, mesh.shape
        assert mesh.ranks.tolist() == [[r] * 4 for r in range(nproc)]
        assert len(mesh.tiles()) == 4
        assert is_primary() == (rank == 0)
        pq, lq, fq = synth(10, 1)
        pr, lr, fr = synth(23, 2)
        got = sharded_pairwise_block(mesh, pq, pr, lq, lr, fq, fr, KLIST,
                                     SS64, BBITS)
        np.savez(out_npz + str(rank), got=got)
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "poppunk_tpu")]
    finally:
        torch.distributed.destroy_process_group()
    print("WORKER_DONE", rank)
""").format(repo=REPO)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_dists(tmp_path):
    import poppunk_tpu.ops.distances as jd
    import poppunk_tpu_torch.ops.distances as td
    from test_parallel import BBITS, KLIST, SS64, synth

    port = _free_port()
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(WORKER)
    out_npz = str(tmp_path / "result")
    env = dict(os.environ, POPPUNK_TPU_TORCH_DEVICE="cpu")
    procs = [subprocess.Popen(
        [sys.executable, str(worker_py), str(i), "2", str(port), out_npz],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        pytest.fail("distributed workers timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{err[-3000:]}"
        assert "WORKER_DONE" in out

    pq, lq, fq = synth(10, 1)
    pr, lr, fr = synth(23, 2)
    one = td.pairwise_block(pq, pr, lq, lr, fq, fr, KLIST, SS64, BBITS,
                            device="cpu")
    want = np.asarray(jd.pairwise_block(pq, pr, lq, lr, fq, fr, KLIST, SS64,
                                        BBITS, use_pallas=False,
                                        use_mesh=False))
    for rank in range(2):
        got = np.load(out_npz + str(rank) + ".npz")["got"]
        assert got.shape == want.shape == (10, 23, 2)
        # every rank sees the whole gathered block
        np.testing.assert_array_equal(got, one)
        np.testing.assert_allclose(got, want, **MESH_TOL)


def test_init_distributed_is_a_no_op_for_one_process(monkeypatch):
    from poppunk_tpu_torch.parallel import init_distributed, is_primary
    from poppunk_tpu_torch.parallel.distributed import pod_mesh

    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert init_distributed() is False
    assert init_distributed(num_processes=1) is False
    assert is_primary()
    mesh = pod_mesh(devices=[torch.device("cpu")] * 4)
    assert mesh.shape == {"q": 1, "r": 4}
    with pytest.raises(ValueError, match="PROCESS_ID"):
        init_distributed(coordinator_address="localhost:1",
                         num_processes=2)
