"""Data-parallel training on a gloo mesh of CPU ranks (the reference's
``data`` mesh axis, tests/test_distributed.py:91,119): each rank steps on
its slice of the global batch, the gradients and the loss are averaged
over the ranks in rank order before AdamW, and every rank ends with the
same parameters, bitwise.  Worlds 1 and 2 as ``sys.executable -c`` rank
processes (tests/test_torch_mesh.py's harness), never importing jax or
repro; the one-process step here is the reference: the loss and the
updated parameters to 1e-5 (float32 sums over half the rows, then added).
``error_feedback_allreduce`` at world 2: one call, bitwise the codes
summed and the scales averaged here, each rank's residual what its own
codes lost.  (The mean code times the mean scale is the reference's
decompression; where the ranks' block scales differ it is not their mean
gradient, and the residual, local by construction, does not carry that
difference: tests/test_torch_train.py holds the unbiased carry at world 1,
as tests/test_training.py does.)
"""
import textwrap

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import init_params, trainable
from repro_torch.training import (adamw_init, compress_int8, decompress_int8, make_train_step,
                                  named_parameters)
from test_torch_mesh import ROOT, _finish, _start

torch.set_num_threads(2)  # intra-op threads per pytest-xdist worker: the workers share the CPUs
WORLDS = (1, 2)
B, S = 4, 32

RANK = textwrap.dedent(r'''
    import sys
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    rank, world, rdv, out, src = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6]
    sys.path.insert(0, src)
    import numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, trainable
    from repro_torch.parallel import data_mesh
    from repro_torch.training import (adamw_init, error_feedback_allreduce, make_train_step,
                                      named_parameters)

    mesh = data_mesh(world, rank, "file://" + rdv, device="cpu")
    cfg = get_arch("qwen3").reduced()
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
    per = B // world
    mine = torch.from_numpy(tok[rank * per:(rank + 1) * per])
    model = trainable(init_params(cfg, seed=0, dtype=torch.float32, device="cpu"))
    named = named_parameters(model)
    step = make_train_step(cfg, lr_fn=1e-3, mesh=mesh)
    _, opt, m = step(model, adamw_init(named), {"tokens": mine, "labels": mine})
    res = {"loss": m["loss"].numpy(), "ce": m["ce"].numpy(), "step": opt.step.numpy()}
    res.update({"p/" + k: p.detach().numpy() for k, p in named.items()})
    res.update({"m/" + k: v.numpy() for k, v in opt.m.items()})
    g = {"w": torch.from_numpy(np.random.default_rng(10 + rank).standard_normal(700)
                               .astype(np.float32))}
    red, r = error_feedback_allreduce(g, {"w": torch.zeros(700)})
    res["ef_reduced"], res["ef_residual"] = red["w"].numpy(), r["w"].numpy()
    np.savez(out, **res)
    dist.destroy_process_group()
''')


def _one_process():
    cfg = get_arch("qwen3").reduced()
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (B, S)))
    model = trainable(init_params(cfg, seed=0, dtype=torch.float32, device="cpu"))
    named = named_parameters(model)
    _, opt, m = make_train_step(cfg, lr_fn=1e-3)(model, adamw_init(named),
                                                  {"tokens": tok, "labels": tok})
    return float(m["loss"]), {k: p.detach().numpy() for k, p in named.items()}


def test_data_parallel_step_equals_one_process(tmp_path):
    code = f"B, S = {B}, {S}\n" + RANK
    started = []
    for w in WORLDS:
        for r in range(w):
            log = tmp_path / f"w{w}_r{r}.log"
            started.append((_start(code, [r, w, tmp_path / f"rdv{w}",
                                          tmp_path / f"w{w}_r{r}.npz", ROOT / "src"], log),
                            log, f"world {w} rank {r}"))
    try:
        loss, params = _one_process()
    finally:
        for proc, log, what in started:
            _finish(proc, log, what)
    res = {w: [dict(np.load(tmp_path / f"w{w}_r{r}.npz")) for r in range(w)] for w in WORLDS}
    for w in WORLDS:
        first = res[w][0]
        for other in res[w][1:]:  # every rank applies the same update
            for k in first:
                if not k.startswith("ef_"):
                    np.testing.assert_array_equal(other[k], first[k], err_msg=k)
        assert abs(float(first["loss"]) - loss) <= 1e-5 * abs(loss)
        assert int(first["step"]) == 1
        for k, p in params.items():
            np.testing.assert_allclose(first["p/" + k], p, rtol=0, atol=1e-5, err_msg=k)
    # world 1 is the one-process step, bitwise
    for k, p in params.items():
        np.testing.assert_array_equal(res[1][0]["p/" + k], p, err_msg=k)

    # error feedback at world 2: the int32 codes summed, the scales averaged
    targets = [torch.from_numpy(np.random.default_rng(10 + r).standard_normal(700)
                                .astype(np.float32)) for r in range(2)]
    packed = [compress_int8(t) for t in targets]
    codes = sum(c.to(torch.int32) for c, _ in packed)
    scale = (packed[0][1] + packed[1][1]) / 2
    want = decompress_int8(codes.float() / 2, scale, (700,)).numpy()
    for r, rank in enumerate(res[2]):
        np.testing.assert_array_equal(rank["ef_reduced"], want)
        own = decompress_int8(*packed[r], (700,)).numpy()
        np.testing.assert_array_equal(rank["ef_residual"], targets[r].numpy() - own)
