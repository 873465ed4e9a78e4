"""The JAX reference's own random draws, recomputed from the same key
splits so the ``test_torch_*`` parity tests can give the port exactly
the rows and initial weights the reference used; and tests that these
per-key recomputations are the draws the reference's ``vmap``ped code
makes."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.fl import cnn as jcnn
from repro.fl.divergence import pair_keys as jax_pair_keys

# six xdist workers share the box: keep each torch process narrow
torch.set_num_threads(2)


def jax_train_draws(clients, keys, *, iters, batch):
    """(N, iters, batch) rows that ``repro.fl.client.train_sources``
    draws with per-device ``keys``: ``jax.random.categorical`` over the
    labeled (else valid) rows, one split key per step."""
    out = []
    for i in range(clients.x.shape[0]):
        labeled = np.asarray(clients.labeled[i])
        sel = labeled if labeled.any() else np.asarray(clients.valid[i])
        logits_w = jnp.where(jnp.asarray(sel), 0.0, -1e30)
        ks = jax.random.split(keys[i], iters)
        out.append([np.asarray(jax.random.categorical(k, logits_w,
                                                      shape=(batch,)))
                    for k in ks])
    return torch.as_tensor(np.asarray(out), dtype=torch.int64)


def jax_pair_draws(counts, pi, pj, keys, *, steps, batch):
    """(P, steps, 2, batch) rows that
    ``repro.fl.divergence.pairwise_divergence_values`` draws per pair."""
    out = []
    for p, k in enumerate(keys):
        lane = []
        for kt in jax.random.split(k, steps):
            ki, kj = jax.random.split(kt)
            lane.append([
                np.asarray(jax.random.randint(ki, (batch,), 0,
                                              counts[pi[p]])),
                np.asarray(jax.random.randint(kj, (batch,), 0,
                                              counts[pj[p]]))])
        out.append(lane)
    return torch.as_tensor(np.asarray(out), dtype=torch.int64)


def jax_round_inputs(devices_n, clients, key, *, train_iters, batch, tau,
                     T, pair_chunk=256):
    """What ``repro.fl.round.prepare_round(devices, key)`` draws
    internally: (init params (numpy), train draws, divergence h0
    (numpy), divergence draws)."""
    from repro.fl.client import init_client_params
    k_init, k_train, k_div = jax.random.split(key, 3)
    params0 = jax.tree_util.tree_map(np.asarray,
                                     init_client_params(devices_n, k_init))
    train = jax_train_draws(clients,
                            jax.random.split(k_train, devices_n),
                            iters=train_iters, batch=batch)
    k_pairs, init_key = jax.random.split(k_div)
    h0 = jax.tree_util.tree_map(np.asarray,
                                jcnn.cnn_init(init_key, num_classes=2))
    pi, pj = np.triu_indices(devices_n, k=1)
    keys = jax_pair_keys(k_pairs, len(pi), pair_chunk)
    div = jax_pair_draws(np.asarray(clients.counts), pi, pj, keys,
                         steps=tau * T, batch=batch)
    return params0, train, h0, div


def test_train_draws_are_the_references():
    """Per-key categorical draws equal the reference's sampler run
    vmapped over devices and scanned keys, as ``train_sources`` runs it."""
    from repro.data import build_network
    from repro.fl.client import stack_clients
    c = stack_clients(build_network("M//MM", num_devices=3,
                                    samples_per_device=12, seed=0))
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    mine = jax_train_draws(c, keys, iters=4, batch=5).numpy()

    def one(labeled, valid, key):
        sel = jnp.where(jnp.any(labeled), labeled, valid)
        logits_w = jnp.where(sel, 0.0, -1e30)
        return jax.vmap(lambda k: jax.random.categorical(
            k, logits_w, shape=(5,)))(jax.random.split(key, 4))

    ref = np.asarray(jax.jit(jax.vmap(one))(c.labeled, c.valid, keys))
    np.testing.assert_array_equal(mine, ref)
    for i in range(3):
        lab = np.asarray(c.labeled[i])
        ok = lab if lab.any() else np.asarray(c.valid[i])
        assert ok[mine[i]].all()


def test_pair_draws_are_the_references():
    counts = np.array([9, 14, 5])
    pi, pj = np.array([0, 1]), np.array([2, 2])
    keys = jax.random.split(jax.random.PRNGKey(8), 2)
    mine = jax_pair_draws(counts, pi, pj, keys, steps=3, batch=4).numpy()

    def lane(i, j, k):
        def step(kt):
            ki, kj = jax.random.split(kt)
            return jnp.stack([
                jax.random.randint(ki, (4,), 0, jnp.asarray(counts)[i]),
                jax.random.randint(kj, (4,), 0, jnp.asarray(counts)[j])])
        return jax.vmap(step)(jax.random.split(k, 3))

    ref = np.asarray(jax.jit(jax.vmap(lane))(pi, pj, keys))
    np.testing.assert_array_equal(mine, ref)
    assert (mine[:, :, 0] < counts[pi, None, None]).all()
    assert (mine[:, :, 1] < counts[pj, None, None]).all()


class JaxSimDraws:
    """The draws ``repro.sim``'s executors make inside a tick, recomputed
    from the reference engine's key (``split(PRNGKey(seed))``'s second
    half): a draws provider for ``repro_torch.sim.SimulationEngine``.
    Tick t trains on ``split(fold_in(key, t), P)`` under both executors
    (the async executor's compact step gathers the eligible lanes' rows
    of the same split), and measures Algorithm 1 from
    ``fold_in(fold_in(key, t), 1)``: the sync bootstrap and the async
    gossip pairs alike (``divergence``)."""

    def __init__(self, cfg):
        self.cfg = cfg
        _, self.key = jax.random.split(jax.random.PRNGKey(cfg.seed))

    def train(self, t, clients):
        keys = jax.random.split(jax.random.fold_in(self.key, t),
                                clients.n_devices)
        return jax_train_draws(clients, keys, iters=self.cfg.train_iters,
                               batch=self.cfg.batch)

    def divergence(self, t, pairs, clients):
        """(h0, rows) of tick t's positional measurement of ``pairs``
        (the sync bootstrap, or the async tick's gossip meetings)."""
        from repro_torch.convert import params_from_jax
        k_div = jax.random.fold_in(jax.random.fold_in(self.key, t), 1)
        k_pairs, init_key = jax.random.split(k_div)
        h0 = jax.tree_util.tree_map(np.asarray,
                                    jcnn.cnn_init(init_key, num_classes=2))
        pi = np.minimum(pairs[:, 0], pairs[:, 1])
        pj = np.maximum(pairs[:, 0], pairs[:, 1])
        keys = jax_pair_keys(k_pairs, len(pi))
        rows = jax_pair_draws(clients.counts.cpu().numpy(), pi, pj, keys,
                              steps=self.cfg.div_tau * self.cfg.div_T,
                              batch=self.cfg.batch)
        return params_from_jax(h0, clients.device), rows

    def refresh(self, pairs, clients):
        """The executor's content-addressed refresh: pair (i, j) draws
        from ``fold_in(fold_in(fold_in(PRNGKey(seed), 2**20), min), max)``
        and every refresh shares the init ``fold_in(PRNGKey(seed),
        2**21)``."""
        from repro_torch.convert import params_from_jax
        root = jax.random.PRNGKey(self.cfg.seed)
        base = jax.random.fold_in(root, 2 ** 20)
        h0 = jax.tree_util.tree_map(np.asarray, jcnn.cnn_init(
            jax.random.fold_in(root, 2 ** 21), num_classes=2))
        pi = np.minimum(pairs[:, 0], pairs[:, 1])
        pj = np.maximum(pairs[:, 0], pairs[:, 1])
        keys = jax.vmap(lambda i, j: jax.random.fold_in(
            jax.random.fold_in(base, i), j))(jnp.asarray(pi), jnp.asarray(pj))
        rows = jax_pair_draws(clients.counts.cpu().numpy(), pi, pj, keys,
                              steps=self.cfg.div_tau * self.cfg.div_T,
                              batch=self.cfg.batch)
        return params_from_jax(h0, clients.device), rows
