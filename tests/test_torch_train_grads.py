"""The port's training forward and train step against the JAX package on
the CPU, at R18 and 48x64 in float32, on the same params (with the 0.2
BN-gamma scaling of torch_port_common) and the same random draws (JAX's
key tree rebuilt by ``forward_train_noise``).

Tolerances. Losses: 1e-5 relative (the same float32 formulas in another
order). Gradients, per leaf: a leaf that ``jax.grad`` gives exactly zero
(frozen groups, p3+ heads that no anchor inside a 48x64 image reaches) is
exactly zero in the port; every other leaf within 2e-2 of its largest
magnitude and with cosine similarity >= 0.9999 to JAX's, and the median
leaf within 1e-3. The maps agree to ~1e-6, but at the few relu inputs and
max-pool ties that lie within that of zero, the two packages take the
other branch: each such flip moves one summand of a leaf's gradient sum by
a few 1e-3 of the leaf's maximum (the stem BN's beta and the mask head's
first conv: up to 7.2e-3, cosine >= 0.99997, measured with 1 and 4 torch
threads), and the leaves upstream of a flip by its share
(tests/test_torch_train_step.py holds the train step)."""

import jax
import numpy as np
import pytest

from torch_port_common import flat, grad_tree, train_setup


def _check_grads(got, ref):
    """Holds every leaf to the rule of the module note; returns each
    nonzero leaf's max |got - ref| over its max |ref|."""
    got, ref = flat(got), flat(ref)
    assert set(got) == set(ref)
    shares = {}
    for name, r in ref.items():
        g = got[name]
        scale = np.abs(r).max()
        if scale == 0:
            assert not g.any(), name
            continue
        shares[name] = np.abs(g - r).max() / scale
        assert shares[name] <= 2e-2, (name, shares[name])
        cos = (g * r).sum() / np.sqrt((g * g).sum() * (r * r).sum())
        assert cos >= 0.9999, (name, cos)
    assert np.median(list(shares.values())) <= 1e-3, \
        np.median(list(shares.values()))
    return shares


@pytest.mark.parametrize("freeze,add_mask", [(-1, False), (-1, True),
                                             (2, False), (2, True)])
def test_forward_train_losses_and_grads_match_jax(freeze, add_mask):
    jm, params, batch, rng, noise, tm, tbatch = train_setup(freeze, add_mask)
    images, gt_boxes, gt_labels, gt_valid, gt_masks = batch

    def loss_fn(p):
        losses = jm.forward_train(p, images, gt_boxes, gt_labels, gt_valid,
                                  rng, gt_masks=gt_masks)
        return losses["total_loss"], losses

    jgrads, jlosses = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    losses = tm.forward_train(*tbatch[:4], gt_masks=tbatch[4], noise=noise)
    assert set(losses) == set(jlosses)
    assert ("mrcnn_loss" in losses) == add_mask
    for k, v in jlosses.items():
        assert losses[k].item() == pytest.approx(float(v), rel=1e-5), k
    losses["total_loss"].backward()
    got = grad_tree(tm)
    _check_grads(got, jax.tree.map(np.asarray, jgrads))
    if freeze == 2:     # the stem and groups 0-2 take no gradient
        for name, g in flat(got["resnet"]).items():
            frozen = name.startswith(("conv0/", "group0/", "group1/",
                                      "group2/"))
            assert (not g.any()) == frozen, name
