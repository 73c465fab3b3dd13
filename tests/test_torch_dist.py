"""The port's object all-gather (navillm_tpu_torch/parallel/dist.py) over
two real gloo processes: unequal payloads round-trip through the padded
pickle exchange, the counterpart of tests/test_multihost_gather.py; and
the single-process forms."""
import pytest

torch = pytest.importorskip("torch")

from navillm_tpu_torch import testing as T  # noqa: E402
from navillm_tpu_torch.parallel import dist as D  # noqa: E402


def _gather(rank):
    import torch.distributed as dist

    from navillm_tpu_torch.parallel.mesh import make_mesh
    local = [{"instr_id": f"r{rank}_{k}", "rank": rank,
              "blob": "x" * (50 + 400 * rank)} for k in range(rank + 1)]
    gathered = D.all_gather_objects(local)
    plan = make_mesh(dp_size=1, tp_size=2, device="cpu")
    # the model group holds both ranks; a data group of one returns [obj]
    by_model = D.all_gather_objects(local, plan.model)
    by_data = D.all_gather_objects(local, plan.data)
    return {"n_parts": len(gathered), "sizes": [len(g) for g in gathered],
            "ids": sorted(m["instr_id"]
                          for m in D.merge_dist_results(gathered)),
            "blobs": [len(g[0]["blob"]) for g in gathered],
            "model": by_model == gathered, "data": by_data == [local],
            "backend": dist.get_backend()}


def test_two_process_object_allgather():
    for res in T.spawn_gloo(_gather, 2):
        assert res["n_parts"] == 2 and res["sizes"] == [1, 2]
        assert res["ids"] == ["r0_0", "r1_0", "r1_1"]
        assert res["blobs"] == [50, 450]
        assert res["model"] and res["data"] and res["backend"] == "gloo"


def test_single_process_forms():
    assert D.all_gather_objects({"a": 1}) == [{"a": 1}]
    assert D.merge_dist_results([[1, 2], [3]]) == [1, 2, 3]
    # no torchrun environment: nothing to join
    assert D.init_distributed() is False


def test_make_mesh_without_a_device_needs_cuda(monkeypatch):
    """No quiet fallback: without CUDA, make_mesh() raises and names
    device='cpu'; given it, the grid is built on the CPU."""
    from navillm_tpu_torch.parallel.mesh import make_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    plan = make_mesh(device="cpu")
    assert (plan.dp_size, plan.tp_size, plan.world_size) == (1, 1, 1)
