"""Device-synthetic face datasets: the ``synth:`` universe.

The port's copy of ``fedfr_tpu/data/synthetic.py``.  A ``synth:`` spec
string stands wherever a dataset root is expected and builds the whole
FedFR data universe at the reference's multiplicities (40 clients x 100
IDs x 61-69 images, a 420,671-image public set over 6,000 IDs, 4,000 x 40
local-verification images) with no data files: each batch's images are
generated on the device from a ``(B,)`` key vector by
``ops/synth_gen.py`` (the kernel on the card, its plain version on the
CPU), equal byte for byte to the JAX package's images of the same spec.

    synth:clients=40,ids_per_client=100,imgs_min=61,imgs_max=69,
          public_ids=6000,public_imgs=420671,veri_ids=4000,veri_imgs=40,
          blend=0.6,blend_frac=0.5,seed=100

Each identity is a coarse ``block x block`` colour template; each sample
adds pixel noise, contrast and brightness jitter and a spatial roll.
Public identities may be blended toward FL identities, so that feature
mining selects realistic subsets.  ``expr`` blends each sample toward a
random distractor template with weight U(0, expr); ``shift_div`` sets the
roll's amplitude to ``size // shift_div``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ops.synth_gen import check_geometry, synth_generate
from ..ops.threefry import prng_key
from .recordio import SplitMeta

# distinct template-id namespaces so that FL, public and blend identities
# never collide (public ids sit far above any FL pool)
PUBLIC_GID_OFFSET = 1 << 20

_FLOAT_KEYS = ("blend", "blend_frac", "expr")


def parse_synth_spec(spec: str) -> Dict[str, float]:
    """``synth:k=v,...`` -> dict, with defaults at the reference's scale."""
    out: Dict[str, float] = dict(
        clients=40, ids_per_client=100, imgs_min=61, imgs_max=69,
        public_ids=6000, public_imgs=420671, public_imgs_min=61,
        public_imgs_max=79, veri_ids=4000, veri_imgs=40,
        blend=0.6, blend_frac=0.5, seed=100, image_size=112, noise=18,
        block=4, expr=0.0, shift_div=8)
    body = spec.split(":", 1)[1] if ":" in spec else ""
    for kv in body.split(","):
        if not kv.strip():
            continue
        k, v = kv.split("=")
        out[k.strip()] = float(v)
    for k in out:
        if k not in _FLOAT_KEYS:
            out[k] = int(out[k])
    return out


def explicit_synth_keys(spec: str) -> set:
    """The keys the spec string names (as opposed to defaulted ones)."""
    body = spec.split(":", 1)[1] if ":" in spec else ""
    return {kv.split("=")[0].strip() for kv in body.split(",") if kv.strip()}


def is_synth_spec(path: str) -> bool:
    return isinstance(path, str) and path.startswith("synth:")


class SyntheticFaceDataset:
    """A record-dataset view over generated images.

    ``labels``: (N,) class of record key k at ``labels[k-1]``.
    ``class_gids``: (num_classes,) template identity of each class.
    ``blend_gids``/``blend_w``: optional per-class template blend.  ``seed``
    is the universe's (shared by every split, so identities look alike
    everywhere); ``dataset_seed`` separates each split's sample stream.
    Batches are generated on ``device``.
    """

    is_device_synthetic = True

    def __init__(self, labels: np.ndarray, class_gids: np.ndarray, *,
                 id_base: int = 0, seed: int = 100, dataset_seed: int = 0,
                 image_size: int = 112, noise: int = 18, block: int = 4,
                 expr: float = 0.0, shift_div: int = 8,
                 blend_gids: Optional[np.ndarray] = None,
                 blend_w: Optional[np.ndarray] = None, device="cuda"):
        check_geometry(image_size, block, shift_div)
        labels = np.asarray(labels, np.int32)
        self._labels_full = labels
        self.class_gids = np.asarray(class_gids, np.int32)
        n_classes = len(self.class_gids)
        self.blend_gids = (np.asarray(blend_gids, np.int32)
                           if blend_gids is not None else self.class_gids)
        self.blend_w = (np.asarray(blend_w, np.float32) if blend_w is not None
                        else np.zeros(n_classes, np.float32))
        self.meta = SplitMeta(num_images=len(labels), num_classes=n_classes,
                              id_base=id_base)
        self.imgidx = np.arange(1, len(labels) + 1)
        self.image_size = image_size
        self.noise = noise
        self.block = block
        self.expr = float(expr)
        self.shift_div = int(shift_div)
        self.seed = seed
        self.dataset_seed = dataset_seed
        self.device = torch.device(device)

    @property
    def num_classes(self) -> Optional[int]:
        return self.meta.num_classes

    @property
    def id_base(self) -> Optional[int]:
        return self.meta.id_base

    def __len__(self) -> int:
        return len(self.imgidx)

    def all_labels(self, full: bool = False) -> np.ndarray:
        if full:
            return self._labels_full
        return self._labels_full[self.imgidx - 1]

    def subset(self, imgidx: np.ndarray) -> "SyntheticFaceDataset":
        view = object.__new__(SyntheticFaceDataset)
        view.__dict__.update(self.__dict__)
        view.imgidx = np.asarray(imgidx)
        return view

    def synth_vectors(self, positions: np.ndarray):
        """Per-image generator inputs of ``positions``: (keys, gids,
        blend_gids, blend_w, dseeds, labels), host vectors; composed across
        splits by ``CombinedDataset`` into one generator launch."""
        keys = self.imgidx[np.asarray(positions)].astype(np.int32)
        labels = self._labels_full[keys - 1]
        return (keys, self.class_gids[labels], self.blend_gids[labels],
                self.blend_w[labels],
                np.full(len(keys), self.dataset_seed, np.int32),
                labels.astype(np.int32))

    def device_batch(self, positions: np.ndarray):
        """(positions) -> (u8 NHWC images on ``device``, host int32 labels)."""
        vecs = self.synth_vectors(positions)
        return synth_device_batch(self, vecs[:5]), vecs[5]

    def read(self, pos: int):
        """One item on the host (rare paths), from the same generator."""
        imgs, labels = self.device_batch(np.array([pos]))
        return imgs[0].cpu().numpy(), int(labels[0])


def synth_device_batch(dataset: SyntheticFaceDataset, vecs) -> torch.Tensor:
    """Generate the images of prepared per-image vectors on the dataset's
    device (one generator launch on the card)."""
    keys, gids, bgids, bw, dseeds = (torch.from_numpy(np.ascontiguousarray(v))
                                     for v in vecs)
    dev = dataset.device
    if dev.type == "cuda":
        # one host->device copy of the packed int32 words
        packed = torch.stack([keys, gids, bgids, bw.view(torch.int32), dseeds])
        keys, gids, bgids, bw, dseeds = packed.pin_memory().to(dev, non_blocking=True)
        bw = bw.view(torch.float32)
    return synth_generate(keys, gids, bgids, bw, dseeds, prng_key(dataset.seed),
                          dataset.image_size, dataset.noise, dataset.block,
                          dataset.expr, dataset.shift_div)


def build_fl_synthetic(spec: Dict, device="cuda") -> Dict[str, object]:
    """The whole FedFR data universe of a spec dict, generated on ``device``.

    Returns {"clients": [SyntheticFaceDataset, ...], "public": ..., "veri":
    ...}.  FL identities 0..C*I-1 are shared by the client shards and the
    veri set (a sample stream of its own); public identities sit at
    PUBLIC_GID_OFFSET + j, a ``blend_frac`` share of them blended toward a
    random FL identity.  The numpy streams ``[seed, 1]`` (clients) and
    ``[seed, 2]`` (public) are the JAX package's, so both packages build
    the same universe from the same spec.
    """
    seed = int(spec["seed"])
    rng = np.random.default_rng([seed, 1])
    rng_pub = np.random.default_rng([seed, 2])
    n_clients, ipc = int(spec["clients"]), int(spec["ids_per_client"])
    common = dict(seed=seed, image_size=int(spec["image_size"]),
                  noise=int(spec["noise"]), block=int(spec.get("block", 4)),
                  expr=float(spec.get("expr", 0.0)),
                  shift_div=int(spec.get("shift_div", 8)), device=device)

    clients = []
    for c in range(n_clients):
        counts = rng.integers(int(spec["imgs_min"]), int(spec["imgs_max"]) + 1,
                              ipc)
        labels = np.repeat(np.arange(ipc, dtype=np.int32), counts)
        gids = (c * ipc + np.arange(ipc)).astype(np.int32)
        clients.append(SyntheticFaceDataset(labels, gids, id_base=c * ipc,
                                            dataset_seed=c + 1, **common))

    # public: the exact total image count, per-ID counts in the split's range
    n_pub, total = int(spec["public_ids"]), int(spec["public_imgs"])
    if total < n_pub:
        raise ValueError(
            f"synth spec: public_imgs={total} < public_ids={n_pub}; every "
            f"public identity needs at least one image")
    counts = rng_pub.integers(int(spec["public_imgs_min"]),
                              int(spec["public_imgs_max"]) + 1, n_pub)
    # reach the exact total, keeping every count >= 1
    delta = total - int(counts.sum())
    step = 1 if delta > 0 else -1
    i = 0
    while delta != 0:
        j = i % n_pub
        if step > 0 or counts[j] > 1:
            counts[j] += step
            delta -= step
        i += 1
    labels = np.repeat(np.arange(n_pub, dtype=np.int32), counts)
    gids = (PUBLIC_GID_OFFSET + np.arange(n_pub)).astype(np.int32)
    n_fl = n_clients * ipc
    blend_gids = rng_pub.integers(0, max(n_fl, 1), n_pub).astype(np.int32)
    blend_on = rng_pub.random(n_pub) < float(spec["blend_frac"])
    blend_w = np.where(blend_on,
                       rng_pub.uniform(0.0, float(spec["blend"]), n_pub),
                       0.0).astype(np.float32)
    public = SyntheticFaceDataset(labels, gids, id_base=0, dataset_seed=500_001,
                                  blend_gids=blend_gids, blend_w=blend_w, **common)

    n_veri, vpi = int(spec["veri_ids"]), int(spec["veri_imgs"])
    vlabels = np.repeat(np.arange(n_veri, dtype=np.int32), vpi)
    vgids = np.arange(n_veri, dtype=np.int32)  # the FL pool's identities
    veri = SyntheticFaceDataset(vlabels, vgids, id_base=0, dataset_seed=900_001,
                                **common)
    return {"clients": clients, "public": public, "veri": veri}
