"""Datasets of training pages and the array <-> image codecs
(univer_ocr_tpu/models/datasets.py).

A dataset is a sized source of pages; `get(idx, layer_tags)` returns the
page's layers as `{tag: (1, H, W, C) float64 array in [0, 1]}`, channels
in LAYER_NAMES order: the uint8 planes over 255.0, exactly as the JAX
package encodes them.  Three sources: the PNG corpus on disk, pages
rendered on demand (`GeneratorDataset`), and an array of uint8 layers,
such as the committed training fixture, which needs no Pillow.  Pillow
is imported where a file is read, a page rendered or an image made, so
the module imports without it.  Random draws take an explicit
`random.Random`.
"""

import json

import numpy as np

from .constants import (LAYER_NAMES, LAYER_NAMES_PLAIN, LAYER_TAGS,
                        TRAIN_DATA_PATH, TRAIN_DATASET_LENGTH, TRAIN_FIXTURE,
                        VALIDATION_DATA_PATH, VALIDATION_DATASET_LENGTH)


def encode_X(image):
    """A PIL L image or an (H, W) uint8 array -> the (1, H, W, 1) float64
    input in [0, 1]: the gray values over 255.0, as the JAX package
    encodes a page."""
    plane = np.asarray(image)
    return plane.reshape((1,) + plane.shape + (1,)) / 255.0


def decode_X_plane(X):
    """An input tensor (or a list of one) -> its (H, W) uint8 gray plane,
    the values decode_X's image holds; numpy only."""
    if isinstance(X, list):
        X = X[0]
    return (np.asarray(X)[0, :, :, 0] * 255).astype(np.uint8)


def decode_X(X):
    """An input tensor (or a list of one) -> a PIL L image."""
    from PIL import Image
    return Image.fromarray(decode_X_plane(X))


def encode_ys(images):
    """A flat list of per-layer PIL images (LAYER_TAGS order) -> a list of
    (1, H, W, C) float targets, one per tag."""
    ys = []
    flat = iter(images)
    for tag in LAYER_TAGS:
        group = [np.asarray(next(flat)) for _ in LAYER_NAMES[tag]]
        ys.append(np.stack(group, axis=-1)[None] / 255.0)
    return ys


def decode_y_planes(y, normalize=False, four_dims=True):
    """Prediction channels -> (uint8 planes, planes thresholded at their
    mean), the values decode_y's images hold; numpy only."""
    y = np.asarray(y)
    channels = ([y[0, :, :, i] for i in range(y.shape[-1])]
                if four_dims else [y])
    raw, binary = [], []
    for grid in channels:
        grid = np.asarray(grid, np.float64)
        if normalize:
            grid = grid - grid.min()
            peak = grid.max()
            if not np.isclose(peak, 0):
                grid = grid / peak
        raw.append((grid * 255).astype(np.uint8))
        binary.append((grid >= grid.mean()).astype(np.uint8) * 255)
    return raw, binary


def decode_y(y, normalize=False, four_dims=True):
    """Prediction channels -> (images, thresholded-at-mean images)."""
    from PIL import Image
    return tuple([Image.fromarray(plane) for plane in planes]
                 for planes in decode_y_planes(y, normalize, four_dims))


def decode_ys(ys, normalize=False):
    """Per-tag predictions -> flat (images, thresholded images) lists."""
    pred_images, thresholded_images = [], []
    for y in ys:
        raw, binary = decode_y(y, normalize)
        pred_images += raw
        thresholded_images += binary
    return pred_images, thresholded_images


def get_layer_names(layer_tags=None):
    tags = LAYER_TAGS if layer_tags is None else layer_tags
    return [name for tag in LAYER_TAGS if tag in tags
            for name in LAYER_NAMES[tag]]


def encode_layers(planes):
    """{layer_name: (H, W) uint8 plane} -> {tag: (1, H, W, C) float64 in
    [0, 1]}, channels stacked in LAYER_NAMES order per tag."""
    encoded = {}
    for tag in LAYER_TAGS:
        stack = [np.asarray(planes[name]) for name in LAYER_NAMES[tag]
                 if name in planes]
        if stack:
            encoded[tag] = np.stack(stack, axis=-1)[None] / 255.0
    return encoded


class BaseDataset:
    """A sized source of pages; `get_planes` gives a page's uint8 layer
    planes by name, `get` encodes them."""

    def __init__(self, size):
        self.size = size

    def __len__(self):
        return self.size

    def get(self, idx, layer_tags=None):
        return encode_layers(self.get_planes(idx, layer_tags=layer_tags))

    def get_planes(self, idx, layer_tags=None):
        raise NotImplementedError()


class Dataset(BaseDataset):
    """`{idx}_{layer_name}.png` files under a directory (the JAX package's
    corpus), decoded with Pillow on first use and cached in memory."""

    def __init__(self, size, dirpath, cache=True):
        super().__init__(size)
        self.dirpath = dirpath
        self._cache = {} if cache else None

    def _load(self, idx, layer_name):
        key = (idx, layer_name)
        if self._cache is not None and key in self._cache:
            return self._cache[key]
        from PIL import Image
        with Image.open(self.dirpath / f'{idx}_{layer_name}.png') as img:
            plane = np.asarray(img.convert('L'))
        if self._cache is not None:
            self._cache[key] = plane
        return plane

    def get_planes(self, idx, layer_tags=None):
        keep = set(get_layer_names(layer_tags))
        return {name: self._load(idx, name)
                for name in LAYER_NAMES_PLAIN if name in keep}


class GeneratorDataset(BaseDataset):
    """Pages rendered on demand (no corpus on disk needed), each from the
    dataset's `rng` (a `random.Random`) in the order they are asked for."""

    def __init__(self, size, width, height, rng):
        super().__init__(size)
        self.width = width
        self.height = height
        self.rng = rng

    def get_planes(self, idx, layer_tags=None):
        from .train_data_generator import render_page
        picture = render_page(self.width, self.height, rng=self.rng)
        keep = set(get_layer_names(layer_tags))
        return {name: np.asarray(img.convert('L'))
                for name, img in picture.items() if name in keep}


class ArrayDataset(BaseDataset):
    """Pages held as one (N, H, W, L) uint8 array whose last axis holds
    the layers named by `layer_names`."""

    def __init__(self, layers, layer_names):
        super().__init__(len(layers))
        self.layers = layers
        self.index = {name: i for i, name in enumerate(layer_names)}

    def get_planes(self, idx, layer_tags=None):
        return {name: self.layers[idx, :, :, self.index[name]]
                for name in get_layer_names(layer_tags)}


class RandomSelectDataset(BaseDataset):
    """A random subset of another dataset, drawn from `rng` (a
    `random.Random`); the trainer drew its per-stage subsets this way."""

    def __init__(self, size, source_dataset, rng):
        super().__init__(size)
        self.source_dataset = source_dataset
        self.selected = rng.sample(range(len(source_dataset)), size)

    def get(self, idx, layer_tags=None):
        return self.source_dataset.get(self.selected[idx],
                                       layer_tags=layer_tags)


def load_page_arrays(path=TRAIN_FIXTURE):
    """(train, validation) ArrayDatasets of a training-pages .npz: uint8
    `train` and `validation` arrays of (N, H, W, L) layers, and the layer
    names in `layer_names` (JSON)."""
    with np.load(path) as f:
        names = json.loads(str(f['layer_names']))
        return (ArrayDataset(f['train'], names),
                ArrayDataset(f['validation'], names))


def _corpus_or_generator(length, dirpath, rng):
    """The PNG corpus on disk once `generate_data` has written it;
    otherwise pages rendered on demand at the corpus's size (720x480),
    so that training works from a clean checkout."""
    if (dirpath / '0_image.png').exists():
        return Dataset(length, dirpath)
    return GeneratorDataset(length, 720, 480, rng)


def train_dataset(rng):
    return _corpus_or_generator(TRAIN_DATASET_LENGTH, TRAIN_DATA_PATH, rng)


def validation_dataset(rng):
    return _corpus_or_generator(VALIDATION_DATASET_LENGTH,
                                VALIDATION_DATA_PATH, rng)
