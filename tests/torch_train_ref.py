"""Shared fixtures of the port's training tests (tests/test_torch_train*.py):
the reduced configs of each family, the same seeded inputs for both
packages, and the port's named tensors (gradients, moments) carried into
the reference's params layout to be held leaf by leaf.

Every test module of the port caps torch at two intra-op threads: pytest-
xdist runs six workers on the CPUs, and torch's default of one thread per
CPU in each of them multiplies the threads of the eager loops beyond the
cores (a serial loop of small operations then runs tens of times slower).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as jget_arch
from repro.models import init_params as jinit
from repro_torch.configs import get_arch
from repro_torch.models import params_from_numpy, params_to_numpy, trainable

torch.set_num_threads(2)

FAMILIES = {"dense": "qwen3-0.6b", "moe": "llama4-maverick-400b-a17b",
            "mla": "deepseek-v2-236b", "hybrid": "zamba2-7b", "xlstm": "xlstm-125m",
            "encdec": "whisper-base", "vlm": "llava-next-34b"}
B, S = 4, 40  # S spans a reduced SSM chunk (32) and a part
LR = 1e-3


def configs(family):
    name = FAMILIES[family]
    return jget_arch(name).reduced(), get_arch(name).reduced()


def batch(cfg, seed=1, b=B, s=S):
    """Seeded numpy inputs: tokens and labels, and the stubs' inputs (the
    VLM's labels span its patches and its text)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
        out["labels"] = rng.integers(0, cfg.vocab, (b, cfg.n_patches + s)).astype(np.int32)
    out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    out.setdefault("labels", out["tokens"].copy())
    return out


def ref_params(jcfg, seed=0):
    """The reference's float32 params as numpy."""
    return jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32))


def port_model(tree, cfg):
    """The port's trainable model on the CPU from the reference's params."""
    return trainable(params_from_numpy(tree, cfg, device="cpu"))


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def as_ref_tree(model, named):
    """The port's tensors by parameter name (gradients, moments) in the
    reference's params layout, as numpy: a copy of ``model`` holding them."""
    twin = copy.deepcopy(model)
    with torch.no_grad():
        for k, p in twin.named_parameters():
            p.data = named[k].detach().float()
    return params_to_numpy(twin)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k in sorted(tree) for k2, v in flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: np.asarray(tree, np.float32)}


def leaf_errors(got, want):
    """{leaf: max |got - want| / max |want|} over the leaves of two trees."""
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w), (sorted(g), sorted(w))
    return {k: float(np.abs(g[k] - w[k]).max() / max(np.abs(w[k]).max(), 1e-30)) for k in w}
