"""PyTorch port: synthetic data, the device store and the sampler against
the JAX package (``contrastiveprosthetics_torch.data``).

Index matrices are made by the JAX package from a key and handed to both
sides, so the gathers must agree bit for bit.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as CFG
from contrastiveprosthetics_torch.data import sampler as port_sampler
from contrastiveprosthetics_torch.data.store import DeviceStore
from contrastiveprosthetics_torch.data.synthetic import make_processed_dataset
from contrastiveprosthetics_tpu.config import DEFAULT_CONFIG as JCFG
from contrastiveprosthetics_tpu.data import sampler as jax_sampler
from contrastiveprosthetics_tpu.data.store import DeviceStore as JaxStore
from contrastiveprosthetics_tpu.data.synthetic import (
    make_processed_dataset as jax_make_processed_dataset,
)

torch.set_num_threads(1)

POSITIONS = [0, 1, 40, 41]  # two DB2 and two DB3 people: both views exist


@pytest.fixture(scope="module")
def dataset():
    return make_processed_dataset(CFG, people_positions=POSITIONS, seed=3)


@pytest.fixture(scope="module")
def stores(dataset):
    emg, pos, glove = dataset
    return DeviceStore(CFG, emg, pos, glove), JaxStore(JCFG, emg, pos, glove)


@pytest.mark.parametrize("positions,seed,separability", [
    ([40, 41], 3, 6.0), ([5, 0, 45], 0, 2.5)])
def test_synthetic_dataset_is_byte_equal(positions, seed, separability):
    ours = make_processed_dataset(CFG, people_positions=positions, seed=seed,
                                  separability=separability)
    theirs = jax_make_processed_dataset(JCFG, people_positions=positions,
                                        seed=seed, separability=separability)
    assert ours[1] == theirs[1]
    for a, b in ((ours[0], theirs[0]), (ours[2], theirs[2])):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("db2", [False, True])
def test_split_views_equal_jax(stores, split, db2):
    port, jstore = stores
    ours, theirs = port.view(split, db2=db2), jstore.view(split, db2=db2)
    for name in ("split", "n_tasks", "n_people", "n_reps", "output_dim", "D",
                 "D_glove", "train"):
        assert getattr(ours, name) == getattr(theirs, name), name
    for name in ("emg_flat", "emg_groups", "glove_flat"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(theirs, name)),
                                      err_msg=name)
    ours.check_indexing()


def test_store_load_reads_the_ingest_files(tmp_path, dataset):
    """``DeviceStore.load`` reads the person-first ``emg.npz`` and
    ``glove.npz`` as the JAX package does."""
    emg, pos, glove = dataset
    np.savez(tmp_path / "emg.npz", emg=np.transpose(emg, (1, 0, 2, 3, 4)),
             people_positions=np.asarray(pos))
    np.savez(tmp_path / "glove.npz", glove=glove)
    ours = DeviceStore.load(CFG, str(tmp_path)).view("test")
    theirs = JaxStore.load(JCFG, str(tmp_path)).view("test")
    np.testing.assert_array_equal(ours.emg_groups.numpy(),
                                  np.asarray(theirs.emg_groups))
    np.testing.assert_array_equal(ours.glove_flat.numpy(),
                                  np.asarray(theirs.glove_flat))


def test_store_rejects_absent_people(dataset):
    emg, _, glove = dataset
    store = DeviceStore(CFG, emg[:, :2], [0, 1], glove)
    with pytest.raises(ValueError, match="none of the requested people"):
        store.view("train")


def test_gathers_from_jax_indices_are_bit_identical(stores):
    port, jstore = stores
    key = jax.random.PRNGKey(5)
    k_perm, _, k_order = jax.random.split(key, 3)
    for split in ("train", "test"):
        v, jv = port.view(split), jstore.view(split)
        emg_rand = jax_sampler.task_permutations(k_perm, jv.n_tasks, jv.D)
        batches, tail = jax_sampler.epoch_batches(k_order, jv.D, 7)
        t_rand = torch.from_numpy(np.array(emg_rand)).long()
        for items in (batches[0], batches[-1], tail):
            t_items = torch.from_numpy(np.array(items)).long()
            if v.train:
                got = port_sampler.gather_train_batch(v.emg_flat, t_rand,
                                                      t_items)
                want = jax_sampler.gather_train_batch(jv.emg_flat, emg_rand,
                                                      items)
            else:
                got = port_sampler.gather_eval_batch(v.emg_groups, t_rand,
                                                     t_items)
                want = jax_sampler.gather_eval_batch(jv.emg_groups, emg_rand,
                                                     items)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("D,bs", [(600, 32), (600, 8), (48, 64), (16, 5)])
def test_epoch_batches_tail_sizes_match_jax(D, bs):
    gen = torch.Generator().manual_seed(0)
    batches, tail = port_sampler.epoch_batches(gen, D, bs)
    j_batches, j_tail = jax_sampler.epoch_batches(jax.random.PRNGKey(0), D, bs)
    assert tuple(batches.shape) == j_batches.shape
    assert tuple(tail.shape) == j_tail.shape
    items = torch.cat([batches.reshape(-1), tail])
    assert torch.equal(items.sort().values, torch.arange(D))


@pytest.mark.parametrize("D,bs", [(16, 5), (24, 8), (48, 64), (7, 3)])
def test_epoch_batches_padded_matches_jax(D, bs):
    """Fed the JAX order, the padded batches, weights and inverse equal the
    JAX package's; the port's own draw keeps the inverse property."""
    key = jax.random.PRNGKey(D)
    order = torch.from_numpy(np.array(jax.random.permutation(key, D))).long()
    got = port_sampler.pad_batches(order, min(bs, D))
    want = jax_sampler.epoch_batches_padded(key, D, bs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    batches, weights, inverse = port_sampler.epoch_batches_padded(
        torch.Generator().manual_seed(1), D, bs)
    assert tuple(batches.shape) == want[0].shape
    assert torch.equal(batches.reshape(-1)[inverse], torch.arange(D))
    assert float(weights.sum()) == D
    assert torch.equal(weights.reshape(-1)[:D], torch.ones(D))


def test_task_and_identity_permutations():
    gen = torch.Generator().manual_seed(2)
    perms = port_sampler.task_permutations(gen, 5, 9)
    want = torch.arange(45).reshape(5, 9)
    assert torch.equal(perms.sort(dim=1).values, want)
    assert not torch.equal(perms, want)
    np.testing.assert_array_equal(
        port_sampler.identity_permutations(5, 9).numpy(),
        np.asarray(jax_sampler.identity_permutations(5, 9)))
    again = port_sampler.task_permutations(torch.Generator().manual_seed(2),
                                           5, 9)
    assert torch.equal(perms, again)
