"""The depth fold of the port (``kernels/fold.py``): its plain backward,
written out in closed form, against autograd through the plain fold and
against ``jax.vjp`` of the JAX package's ``composite_chunks``; the
differentiable fold of every chunk; and ``parallel.depth._GatherFold`` in
gloo process groups of 1, 2 and 4 ranks against the gather and fold it
replaces (``parallel.render.gather_blocks`` + ``parallel.depth.
fold_partials``).  The kernels themselves, compiled by g++ for the CPU and
on the card, are in ``tests/test_torch_kernels.py``.

The worker of the process-group test is this file run as a script:

    python tests/test_torch_fold.py OUT_DIR WORLD RANK

Inputs are made with NumPy from a seed: premultiplied partials (rgb =
alpha * colour, alpha in [0, 1)), ray directions of both signs along every
axis, and a normal cotangent ``g``.  Tolerances: the closed-form gradient
within ``1e-6 * max|grad|`` of autograd (the two round the transmittance
and the fold of the chunks behind in another order); the folded image
through ``_GatherFold`` bit for bit (the same operations in the same
order).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-6
SHAPE = (10, 7)                 # rays: (V*H, W) of a stacked frame


def partials(n, shape=SHAPE, seed=0):
    """``(n, *shape, 4)`` premultiplied partials from a seed."""
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0.0, 0.999, size=(n,) + shape + (1,))
    rgb = alpha * rng.uniform(size=(n,) + shape + (3,))
    return torch.from_numpy(np.concatenate([rgb, alpha], -1).astype(
        np.float32))


def mixed_dirs(shape=SHAPE, seed=1):
    """Unit ray directions whose components take both signs."""
    d = np.random.default_rng(seed).normal(size=shape + (3,))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(d.astype(np.float32))


def cotangent(shape=SHAPE, seed=2):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape + (4,)).astype(np.float32))


def autograd_grads(parts, dirs, axis, g):
    """The gradient of ``sum(fold_partials * g)`` in every chunk's partial,
    by autograd through the plain fold."""
    from volumetric_renderer_torch.parallel.depth import fold_partials

    x = parts.clone().requires_grad_(True)
    (fold_partials(x, dirs, axis) * g).sum().backward()
    return x.grad


def assert_rel_close(got, want, rel=REL):
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=rel * float(want.abs().max()))


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_fold_backward_plain_equals_autograd(n, axis):
    """Every chunk's closed-form gradient against autograd through
    ``fold_partials``, on rays marching both ways along ``axis``."""
    from volumetric_renderer_torch.kernels.fold import fold_backward_plain

    parts, dirs, g = partials(n), mixed_dirs(), cotangent()
    d = dirs[..., 2 - axis]
    assert bool((d < 0).any()) and bool((d > 0).any())
    want = autograd_grads(parts, dirs, axis, g)
    assert float(want.abs().max()) > 0.5
    for r in range(n):
        assert_rel_close(fold_backward_plain(parts, dirs, axis, g, r),
                         want[r])


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_fold_backward_plain_equals_jax_vjp_on_one_way_views(n, reverse):
    """On rays that all march one way, every chunk's closed-form gradient
    is ``jax.vjp`` of the JAX package's ``composite_chunks(reverse=...)``,
    and the plain fold is its forward bit for bit."""
    import jax
    import jax.numpy as jnp

    from volumetric_renderer_tpu.parallel.depth import composite_chunks
    from volumetric_renderer_torch.kernels.fold import (
        fold_backward_plain, fold_forward_plain,
    )

    axis = 1
    parts, g = partials(n, seed=5), cotangent(seed=6)
    dirs = mixed_dirs(seed=7).abs() * (-1.0 if reverse else 1.0)
    img, vjp = jax.vjp(lambda *p: composite_chunks(list(p), reverse=reverse),
                       *[jnp.asarray(p.numpy()) for p in parts])
    want = vjp(jnp.asarray(g.numpy()))
    np.testing.assert_array_equal(
        fold_forward_plain(parts, dirs, axis).numpy(), np.asarray(img))
    for r in range(n):
        assert_rel_close(fold_backward_plain(parts, dirs, axis, g, r),
                         torch.from_numpy(np.array(want[r])))


@pytest.mark.parametrize("n", [1, 3, 4])
def test_differentiable_fold_on_cpu_is_the_plain_fold(n):
    """``kernels.fold.fold`` on CPU tensors: the plain fold's image bit for
    bit, and every chunk's gradient within the bar of autograd."""
    from volumetric_renderer_torch.kernels.fold import fold
    from volumetric_renderer_torch.parallel.depth import fold_partials

    parts, dirs, g = partials(n, (37,)), mixed_dirs((37,)), cotangent((37,))
    x = parts.clone().requires_grad_(True)
    img = fold(x, dirs, 0)
    assert torch.equal(img, fold_partials(parts, dirs, 0))
    (img * g).sum().backward()
    assert_rel_close(x.grad, autograd_grads(parts, dirs, 0, g))


def test_fold_wrappers_refuse_what_they_do_not_take():
    from volumetric_renderer_torch.kernels.fold import (
        fold_backward, fold_forward,
    )

    parts, dirs, g = partials(2), mixed_dirs(), cotangent()
    with pytest.raises(ValueError, match="no kernel"):
        fold_forward(parts.to("meta"), dirs.to("meta"), 0)
    with pytest.raises(TypeError, match="float32"):
        fold_forward(parts.double(), dirs, 0)
    with pytest.raises(ValueError, match="same rays"):
        fold_forward(parts, dirs[:-1], 0)
    with pytest.raises(ValueError, match="axis"):
        fold_forward(parts, dirs, 3)
    with pytest.raises(ValueError, match="g must be"):
        fold_backward(parts, dirs, 0, g[:-1], 0)
    with pytest.raises(ValueError, match="chunk 2 of 2"):
        fold_backward(parts, dirs, 0, g, 2)


def test_fold_partials_keeps_its_name_and_result():
    """``parallel.depth.fold_partials`` and ``over`` are the plain fold of
    ``kernels.fold``, with ``composite_chunks`` on one-way rays."""
    from volumetric_renderer_torch.kernels import fold as kfold
    from volumetric_renderer_torch.parallel import depth

    assert depth.fold_partials is kfold.fold_forward_plain
    assert depth.over is kfold.over
    parts = partials(3)
    dirs = mixed_dirs().abs()
    assert torch.equal(depth.fold_partials(parts, dirs, 2),
                       depth.composite_chunks(list(parts)))
    assert torch.equal(depth.fold_partials(parts, -dirs, 2),
                       depth.composite_chunks(list(parts), reverse=True))


# -- _GatherFold in gloo process groups ----------------------------------------

AXES = (0, 1, 2)


def worker(out_dir, world, rank):
    """Each axis: ``_GatherFold`` and the gather + fold it replaces on this
    rank's partial; results to ``out_dir/rank{rank}.pt``."""
    import torch.distributed as dist

    from volumetric_renderer_torch.parallel import depth, distributed
    from volumetric_renderer_torch.parallel.render import gather_blocks

    torch.set_num_threads(1)
    distributed.init_distributed(
        f"file://{os.path.join(out_dir, 'store')}", world, rank, device="cpu")
    parts, dirs, g = partials(world, seed=11), mixed_dirs(), cotangent()
    res = {"world": dist.get_world_size(), "rank": dist.get_rank()}
    for axis in AXES:
        x = parts[rank].clone().requires_grad_(True)
        img = depth._GatherFold.apply(x, dirs, axis, None, rank, world)
        (img * g).sum().backward()
        y = parts[rank].clone().requires_grad_(True)
        want = depth.fold_partials(gather_blocks(y[None]), dirs, axis)
        (want * g).sum().backward()
        res[axis] = (img.detach(), x.grad, want.detach(), y.grad)
    dist.barrier()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module", params=[1, 2, 4],
                ids=["world1", "world2", "world4"])
def gather_fold_runs(request, tmp_path_factory):
    """Run ``world`` worker processes once; ``(world, [result per rank])``."""
    world = request.param
    out = tmp_path_factory.mktemp(f"fold{world}")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RANK", "WORLD_SIZE", "LOCAL_", "MASTER_"))}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(out), str(world),
         str(r)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO) for r in range(world)]
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            _, err = p.communicate()
        assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
    return world, [torch.load(out / f"rank{r}.pt", weights_only=False)
                   for r in range(world)]


@pytest.mark.parametrize("axis", AXES)
def test_gather_fold_equals_gather_then_fold_in_a_group(gather_fold_runs,
                                                        axis):
    """In a gloo group of 1, 2 or 4 ranks, ``_GatherFold`` gives every rank
    the image of ``gather_blocks`` + ``fold_partials`` bit for bit (the
    whole fold of every rank's partial), and this rank's partial the
    gradient that their autograd gives it, within ``1e-6 * max|grad|``."""
    from volumetric_renderer_torch.parallel.depth import fold_partials

    world, res = gather_fold_runs
    parts, dirs, g = partials(world, seed=11), mixed_dirs(), cotangent()
    whole = fold_partials(parts, dirs, axis)
    grads = autograd_grads(parts, dirs, axis, g)
    assert [(r["world"], r["rank"]) for r in res] == \
        [(world, i) for i in range(world)]
    for rank, r in enumerate(res):
        img, grad, want_img, want_grad = r[axis]
        assert torch.equal(img, want_img) and torch.equal(img, whole)
        assert_rel_close(grad, want_grad)
        assert_rel_close(grad, grads[rank])
        if world == 1:
            assert torch.equal(img, parts[0]) and torch.equal(grad, g)


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
