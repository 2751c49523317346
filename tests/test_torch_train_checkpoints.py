"""Checkpoints of every family's train state, and the train CLI's
reference behaviour for the frontend families, on the CPU:

  * train/checkpoint.py round-trips the port's own state (params and an
    AdamW state with the error-feedback residual) of the MoE trees (the
    (layers, experts, K, N) expert stacks and the shared expert), the
    recurrent trees (RG-LRU, mLSTM, sLSTM), the encoder tree (its layers,
    norm and cross blocks) and the VLM's frontend projection: every leaf
    restored bit-equal, with its dtype, under its path;
  * a checkpoint the reference's checkpoint.save wrote of each family's
    params and optimizer state restores into the port, leaf for leaf
    equal to the reference's arrays (qwen3's case is
    tests/test_torch_train.py's);
  * `launch.train --arch whisper-small|internvl2-76b` raises the
    reference's KeyError: 'frontend' in both packages (host_batch gives
    tokens and labels only; forward_train reads the frontend).  Those
    two train through make_train_step with a batch that holds it
    (tests/test_torch_train_encdec.py, test_torch_train_vlm.py).
"""
import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro import configs as rconfigs
from repro.launch import train as rlaunch
from repro.models import transformer as RT
from repro.train import OptConfig as ROC
from repro.train import checkpoint as rckpt
from repro.train import optimizer as ropt
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as TT
from repro_torch.train import OptConfig as TOC
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt

ARCHS = ["mixtral-8x7b", "llama4-scout-17b-a16e", "recurrentgemma-2b",
         "xlstm-125m", "whisper-small", "internvl2-76b"]
# a path of each family's tree that the round trip must carry, and its
# leaf's rank
FAMILY_LEAF = {"mixtral-8x7b": ("units/0/moe/w_up", 4),
               "llama4-scout-17b-a16e": ("units/0/moe/shared/w_down", 3),
               "recurrentgemma-2b": ("units/0/rec/conv", 3),
               "xlstm-125m": ("units/2/slstm/wo_gate", 3),
               "whisper-small": ("enc/cross/attn/wk", 3),
               "internvl2-76b": ("frontend_proj", 2)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    with threadpool_limits(limits=1):
        yield


def _state(params):
    """params and a compressing AdamW state whose moments and residual
    are not zero (one step's worth of made-up gradients)."""
    toc = TOC(compress_grads=True)
    opt = topt.init(params, toc)
    g = torch.Generator().manual_seed(7)
    grads = topt.tree_map(lambda p: torch.randn(p.shape, generator=g), params)
    params, opt = topt.apply(params, grads, opt, toc)
    return {"params": params, "opt": opt}


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_round_trips_the_family_tree(tmp_path, arch):
    cfg = tconfigs.get_smoke(arch)
    tree = _state(TT.init_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu"))
    d = str(tmp_path / "ck")
    tckpt.save(d, 1, tree)
    tmpl = topt.tree_map(torch.zeros_like, tree["params"])
    tmpl = {"params": tmpl, "opt": topt.init(tmpl, TOC(compress_grads=True))}
    restored, step = tckpt.restore(d, tmpl)
    assert step == 1
    want, got = tckpt._flatten(tree), tckpt._flatten(restored)
    assert list(got) == list(want)
    for k, a in want.items():
        assert a.dtype == got[k].dtype and torch.equal(a, got[k]), k
    path, rank = FAMILY_LEAF[arch]
    assert got[f"params/{path}"].dim() == rank
    assert got[f"opt/.mu/{path}"].abs().max() > 0
    assert got["opt/.step"].dtype == torch.int32 and int(got["opt/.step"]) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_restores_into_the_port(tmp_path, arch):
    cfg_r, cfg_t = rconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    ref_params = RT.init_params(jax.random.PRNGKey(0), cfg_r)
    r_state = ropt.init(ref_params, ROC(compress_grads=True))
    d = str(tmp_path / "ck")
    rckpt.save(d, 3, {"params": ref_params, "opt": r_state})
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                   cfg_t, device="cpu")
    tmpl = {"params": topt.tree_map(torch.zeros_like, tp),
            "opt": topt.init(tp, TOC(compress_grads=True))}
    restored, step = tckpt.restore(d, tmpl)
    assert step == 3
    got = topt.tree_leaves(restored["params"])
    want = jax.tree.leaves(ref_params)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert restored["opt"].step.dtype == torch.int32
    assert int(restored["opt"].step) == 0


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-76b"])
def test_train_cli_raises_the_references_frontend_keyerror(arch):
    argv = ["--arch", arch, "--smoke", "--steps", "1", "--batch", "2",
            "--seq", "16"]
    with pytest.raises(KeyError) as ref_err:
        rlaunch.main(argv)
    with pytest.raises(KeyError) as port_err:
        tlaunch.main(argv + ["--device", "cpu"])
    assert ref_err.value.args == port_err.value.args == ("frontend",)
