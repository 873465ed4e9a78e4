"""Numpy copy of ``repro.data.partition``: the port imports nothing of the JAX
package.

Federated data partitioning (Sec. V experimental setup).

Devices receive non-i.i.d. Dirichlet label mixtures over a base dataset (or
per-device domain assignments for the split setting), and each device is
assigned a labeled-data ratio: half the network partially labeled with random
ratios, the rest fully unlabeled — exactly the paper's protocol.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.data.digits import (DigitDataset, make_domain_dataset,
                                    make_mixture)


@dataclasses.dataclass
class DeviceData:
    images: np.ndarray          # (n_i, 28, 28, 3)
    labels: np.ndarray          # (n_i,) int32; -1 where unlabeled
    labeled_mask: np.ndarray    # (n_i,) bool
    domain_ids: np.ndarray      # (n_i,) int32
    true_labels: np.ndarray = None  # (n_i,) int32 — held out, eval only

    @property
    def n(self) -> int:
        return len(self.labels)

    @property
    def n_labeled(self) -> int:
        return int(self.labeled_mask.sum())


def dirichlet_label_split(labels: np.ndarray, num_devices: int,
                          alpha: float, rng: np.random.Generator
                          ) -> List[np.ndarray]:
    """Index sets per device with Dirichlet(alpha) per-class proportions."""
    idx_by_class = [np.flatnonzero(labels == c) for c in np.unique(labels)]
    device_idx: List[List[int]] = [[] for _ in range(num_devices)]
    for idx in idx_by_class:
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(num_devices, alpha))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for dev, part in enumerate(np.split(idx, cuts)):
            device_idx[dev].extend(part.tolist())
    return [np.asarray(sorted(d)) for d in device_idx]


def assign_label_ratios(num_devices: int, rng: np.random.Generator,
                        frac_partially_labeled: float = 0.5,
                        min_ratio: float = 0.3, max_ratio: float = 0.9
                        ) -> np.ndarray:
    """Per-device labeled ratios: the paper labels half the network with
    random ratios and leaves the other half fully unlabeled."""
    n_lab = int(round(num_devices * frac_partially_labeled))
    ratios = np.zeros(num_devices)
    which = rng.permutation(num_devices)[:n_lab]
    ratios[which] = rng.uniform(min_ratio, max_ratio, size=n_lab)
    return ratios


def build_network(setting: str, num_devices: int = 10,
                  samples_per_device: int = 600, seed: int = 0,
                  dirichlet_alpha: float = 0.5,
                  label_subset: Optional[Sequence[int]] = None
                  ) -> List[DeviceData]:
    """The paper's three dataset manipulations:

      single: "M" | "U" | "MM"            (one domain, Dirichlet non-iid)
      mixed:  "M+MM" etc.                 (every device mixes both domains)
      split:  "M//U" etc.                 (each device draws ONE domain)
    """
    rng = np.random.default_rng(seed)
    total = num_devices * samples_per_device

    if "//" in setting:                       # split
        domains = setting.split("//")
        dev_domains = [domains[i % len(domains)] for i in range(num_devices)]
        per_dev_sets = [
            make_domain_dataset(dom, samples_per_device, seed + 101 * i,
                                label_subset)
            for i, dom in enumerate(dev_domains)]
        parts = [(ds.images, ds.labels, ds.domain_ids) for ds in per_dev_sets]
    else:
        if "+" in setting:                    # mixed
            domains = setting.split("+")
            spec = {d: total // len(domains) for d in domains}
            base = make_mixture(spec, seed, label_subset)
        else:                                 # single
            base = make_domain_dataset(setting, total, seed, label_subset)
        splits = dirichlet_label_split(base.labels, num_devices,
                                       dirichlet_alpha, rng)
        parts = [(base.images[s], base.labels[s], base.domain_ids[s])
                 for s in splits]

    ratios = assign_label_ratios(num_devices, rng)
    devices = []
    for (imgs, labs, doms), ratio in zip(parts, ratios):
        n = len(labs)
        mask = np.zeros(n, bool)
        k = int(round(ratio * n))
        if k:
            mask[rng.permutation(n)[:k]] = True
        shown = np.where(mask, labs, -1).astype(np.int32)
        devices.append(DeviceData(imgs.astype(np.float32), shown, mask,
                                  doms.astype(np.int32),
                                  labs.astype(np.int32)))
    return devices


def reveal_labels(dev: DeviceData, frac: float,
                  rng: np.random.Generator) -> DeviceData:
    """Label-arrival re-partitioning: a copy of ``dev`` with ``frac`` of
    its currently-unlabeled samples flipped to labeled (the ground-truth
    labels are revealed).  Devices whose labels 'arrive' this way can flip
    from target to source on the next (P) re-solve."""
    hidden = np.flatnonzero(~dev.labeled_mask)
    k = int(round(frac * len(hidden)))
    if k == 0:
        return dev
    mask = dev.labeled_mask.copy()
    mask[rng.choice(hidden, size=k, replace=False)] = True
    shown = np.where(mask, dev.true_labels, -1).astype(np.int32)
    return DeviceData(dev.images, shown, mask, dev.domain_ids,
                      dev.true_labels)


def interpolate_features(base: DeviceData, alt_images: np.ndarray,
                         mix: float) -> DeviceData:
    """Feature-drift re-partitioning: a copy of ``base`` whose images are
    the pixel-wise convex mix ``(1 - mix) * base + mix * alt_images`` —
    the device's feature distribution sliding from its original domain
    toward an alternative render of the SAME samples (labels, masks and
    ground truth are untouched: only features drift, exactly the
    covariate-shift regime the paper's divergence bound prices).

    ``mix`` is ABSOLUTE (0 = original, 1 = fully the alt domain), so a
    time-varying schedule re-applies against the same cached ``base``
    rather than compounding round-over-round blends; callers keep the
    pristine original (the engine caches it at the first drift).

    ``alt_images`` must be a per-sample aligned render of ``base``'s
    labels (see ``repro.data.digits.render_images``)."""
    if alt_images.shape != base.images.shape:
        raise ValueError(
            f"alt_images shape {alt_images.shape} does not match device "
            f"images {base.images.shape}; render the device's own labels")
    m = float(np.clip(mix, 0.0, 1.0))
    img = ((1.0 - m) * base.images + m * alt_images).astype(np.float32)
    return DeviceData(img, base.labels, base.labeled_mask,
                      base.domain_ids, base.true_labels)


def make_device(setting: str, samples_per_device: int, seed: int,
                labeled_ratio: float,
                label_subset: Optional[Sequence[int]] = None,
                rng: Optional[np.random.Generator] = None) -> DeviceData:
    """Churn re-partitioning: build ONE fresh device for the given setting
    (a joining device in the repro.sim ``device-churn`` scenario).  Split
    settings draw a single random domain; mixed settings mix all domains;
    single settings use that domain."""
    rng = rng if rng is not None else np.random.default_rng(seed)
    if "//" in setting:
        dom = setting.split("//")[int(rng.integers(
            len(setting.split("//"))))]
        ds = make_domain_dataset(dom, samples_per_device, seed, label_subset)
    elif "+" in setting:
        domains = setting.split("+")
        spec = {d: samples_per_device // len(domains) for d in domains}
        ds = make_mixture(spec, seed, label_subset)
    else:
        ds = make_domain_dataset(setting, samples_per_device, seed,
                                 label_subset)
    n = len(ds.labels)
    mask = np.zeros(n, bool)
    k = int(round(labeled_ratio * n))
    if k:
        mask[rng.permutation(n)[:k]] = True
    shown = np.where(mask, ds.labels, -1).astype(np.int32)
    return DeviceData(ds.images.astype(np.float32), shown, mask,
                      ds.domain_ids.astype(np.int32),
                      ds.labels.astype(np.int32))


def iterate_minibatches(x: np.ndarray, y: np.ndarray, batch: int,
                        rng: np.random.Generator, iters: int):
    """Yield ``iters`` shuffled minibatches (with reshuffling epochs)."""
    n = len(y)
    order = rng.permutation(n)
    at = 0
    for _ in range(iters):
        if at + batch > n:
            order = rng.permutation(n)
            at = 0
        sel = order[at:at + batch]
        at += batch
        yield x[sel], y[sel]
