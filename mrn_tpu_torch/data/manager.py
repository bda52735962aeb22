"""The incremental data stream and the evaluation loaders (the port's copies
of ``EpochLoader``, ``DatasetManager`` and ``ValDataset`` from
``mrn_tpu/data/manager.py``).

``EpochLoader`` has two forms:

- training (``shuffle=True``): a permutation from the shared generator per
  epoch (one when built), ``next_batch`` restarting at the end of an epoch,
  ``skip_batch`` (the same draws without collating), and ``with_index``
  batches ``(images, labels, dataset_idx)``;
- evaluation (``shuffle=False, pad_to_batch=True``): dataset order, the
  last batch padded to the batch size with zero images and ``""`` labels,
  yielding ``(images, labels, n_valid)``.

``DatasetManager(opt, dataset_factory)`` builds the training stream from
``dataset_factory(data_root, taski, mode) -> dataset`` over
``opt.select_data``, each task's dataset repeated to about 50k samples,
and draws everything from one generator seeded ``opt.manual_seed``:

- ``get_dataset(taski, memory=None)``: the current task alone (step 0);
- ``get_dataset(taski, memory, index_list)`` with ``il="mrn"``: one stream
  of the rehearsal memory (``index_list[i]`` of task ``i``) and
  ``memory_num / taski`` current samples, tagged memory (0) / current (1)
  under ``router_labels="reference"`` or with the task id under
  ``"task"``;
- ``get_dataset(taski, "test_ch", index_list)``: one stream of the memory
  (each task's full dataset repeated before its indices are taken) and
  the current task;
- ``get_dataset(taski, "large", index_list)``: one stream of the memory
  (``memory_num * taski``) and ``memory_num`` current samples;
- ``get_dataset(taski, "total")``: one stream of the current task and
  every earlier task in full;
- ``get_dataset(taski, memory, index_list)``, any other policy name (the
  configs' ``"random"``) with another ``il``: two loaders of
  ``batch_size // 2``, the memory's then the current task's;
- ``joint_start(opt, select_data, log, taski, total_task)``, called once
  per task: ``il="joint_mix"`` gathers each task's dataset in
  ``data_list`` and after the last task builds one loader over them all;
  ``"joint_loader"`` adds one loader of ``batch_size // total_task`` per
  task;
- ``get_batch()`` / ``get_batch2()``: one batch per loader, in loader
  order, concatenated; ``skip_batches(n)``: n such rounds without
  collating.

Every loader built draws its first permutation from the generator when it
is built, and one more at each new epoch.  The LMDB factory raises
(ROADMAP.md §1 item 6).

``ValDataset(val_datas, opt, dataset_factory)`` builds, from
``dataset_factory(val_data) -> dataset``, the current (last) set's loader
(``create_dataset``, step-0 validation) and every set's, each capped at
700 crops drawn with the ValDataset's generator (``create_list_dataset``,
the routed validation).

Items are uint8 crops already at ``(imgH, imgW)`` (a crop of another size
raises: the port has no resize), float32 crops or bank indices.  uint8
batches stay uint8 (normalised on the device), other integer batches are
int32 bank indices, images float32.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from mrn_tpu_torch.data.dataset import ConcatDataset, IndexConcatDataset, Subset

__all__ = ["DatasetManager", "EpochLoader", "ValDataset"]

# the reference caps each test set of the all-task validation at 700 crops
LIST_CAP = 700
# small datasets are repeated to about this many samples a task
REPEAT_TO = 50000


def _identity(image):
    return image


class EpochLoader:
    """Batches of ``batch_size`` over ``dataset``; see the module doc."""

    def __init__(self, dataset, batch_size: int, transform: Optional[Callable] = None,
                 shuffle: bool = True, with_index: bool = False, pad_to_batch: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.transform = transform or _identity
        self.shuffle = shuffle
        self.with_index = with_index
        self.pad_to_batch = pad_to_batch
        self.rng = rng or np.random.default_rng()
        self._order = None
        self._pos = 0
        self._new_epoch()

    def _new_epoch(self):
        n = len(self.dataset)
        self._order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        self._pos = 0

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def _collate(self, items):
        if self.with_index:
            pairs, idxs = zip(*items)
        else:
            pairs, idxs = items, None
        images = [self.transform(im) for im, _ in pairs]
        labels = [lb for _, lb in pairs]
        n_valid = len(images)
        if self.pad_to_batch and n_valid < self.batch_size:
            pad = self.batch_size - n_valid
            images += [np.zeros_like(images[0])] * pad
            labels += [""] * pad
        batch = np.stack(images)
        if batch.dtype != np.uint8:
            batch = batch.astype(np.int32 if np.issubdtype(batch.dtype, np.integer)
                                 else np.float32)
        if self.with_index:
            return batch, labels, np.asarray(idxs, dtype=np.int32)
        if self.pad_to_batch:
            return batch, labels, n_valid
        return batch, labels

    def next_batch(self):
        if self._pos >= len(self._order):
            self._new_epoch()
        sel = self._order[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        return self._collate([self.dataset[int(i)] for i in sel])

    def skip_batch(self):
        """``next_batch``'s draws without collating (resume's fast-forward)."""
        if self._pos >= len(self._order):
            self._new_epoch()
        self._pos += self.batch_size

    def __iter__(self):
        self._new_epoch()
        while self._pos < len(self._order):
            yield self.next_batch()


def _sized(opt) -> Callable:
    """The training transform: uint8 crops must already be ``(imgH,
    imgW)``; bank indices and float crops pass as they are."""
    size = (int(opt.imgH), int(opt.imgW))

    def check(image):
        if isinstance(image, np.ndarray) and image.ndim == 3 and image.shape[:2] != size:
            raise ValueError(f"crop of {image.shape[:2]}, expected {size}: the port "
                             "has no resize (ROADMAP.md §1 item 6)")
        return image

    return check


class DatasetManager:
    """The incremental stream builder; see the module doc."""

    def __init__(self, opt, dataset_factory: Optional[Callable] = None,
                 seed: Optional[int] = None):
        self.opt = opt
        self.select_data: Optional[Sequence[str]] = None
        self.data_list: List = []          # joint_mix's datasets, one a task
        self.loaders: List[EpochLoader] = []
        self.rng = np.random.default_rng(opt.manual_seed if seed is None else seed)
        self._factory = dataset_factory or self._lmdb_factory

    # ------------------------------------------------ dataset construction
    def _lmdb_factory(self, data_root: str, taski: int, mode: str):
        raise NotImplementedError("LMDB datasets are not ported yet (ROADMAP.md §1 "
                                  "item 6): pass a dataset_factory")

    def create_dataset(self, data_list=None, taski: int = 0, mode: str = "train",
                       repeat: bool = True):
        """Task ``taski`` over every data root, each repeated to about 50k
        samples unless ``repeat`` is off."""
        datasets = []
        for data_root in (data_list or self.select_data):
            ds = self._factory(data_root, taski, mode)
            if len(ds) < REPEAT_TO and repeat:
                ds = ConcatDataset([ds] * int(REPEAT_TO / len(ds)))
            datasets.append(ds)
        return ConcatDataset(datasets)

    def _add_loader(self, dataset, batch_size=None, with_index=False):
        self.loaders.append(EpochLoader(
            dataset, batch_size or self.opt.batch_size, _sized(self.opt),
            with_index=with_index, rng=self.rng))

    # -------------------------------------------------------- policies
    def init_start(self, opt, select_data, log, taski):
        self.opt = opt
        self.select_data = select_data
        self.loaders = []
        if log is not None:
            log.write(f"select_data: {select_data}\n")
        self.get_dataset(taski, memory=None)

    def joint_start(self, opt, select_data, log, taski, total_task):
        self.opt = opt
        self.select_data = select_data
        dataset = self.create_dataset(data_list=select_data, taski=taski)
        if opt.il == "joint_mix":
            self.data_list.append(dataset)
            if taski == total_task - 1:
                self._add_loader(ConcatDataset(self.data_list), int(opt.batch_size))
        elif opt.il == "joint_loader":
            self._add_loader(dataset, int(opt.batch_size // total_task))

    def get_dataset(self, taski, memory="random", index_list=None):
        """Builds task ``taski``'s stream; returns the memory index list."""
        self.loaders = []
        # full-state resume rebuilds the stream from this generator state
        self.rng_state_at_build = self.rng.bit_generator.state
        memory_num = self.opt.memory_num
        dataset = self.create_dataset(data_list=self.select_data, taski=taski)

        if memory is not None and self.opt.il == "mrn":
            index_current = self.rng.choice(len(dataset), int(memory_num / taski),
                                            replace=False)
            split_dataset = Subset(dataset, index_current.tolist())
            if self.opt.get("router_labels", "reference") == "task":
                # one subset per task, so dataset_idx is the task id
                parts = []
                for i in range(taski):
                    ds_i = self.create_dataset(data_list=self.select_data, taski=i,
                                               repeat=False)
                    parts.append(Subset(ds_i, list(index_list[i])))
                parts.append(split_dataset)
                self._add_loader(IndexConcatDataset(parts), self.opt.batch_size,
                                 with_index=True)
            else:
                # the memory nests as ONE element: dataset_idx memory 0 / current 1
                memory_data, index_list = self.rehearsal_memory(
                    taski, total_num=memory_num, index_array=index_list)
                self._add_loader(IndexConcatDataset([memory_data, split_dataset]),
                                 self.opt.batch_size, with_index=True)
        elif memory == "test_ch":
            memory_data, index_list = self.rehearsal_memory(
                taski, total_num=memory_num, index_array=index_list, repeat=True)
            self._add_loader(ConcatDataset([memory_data, dataset]), self.opt.batch_size)
        elif memory == "large":
            index_current = self.rng.choice(len(dataset), memory_num, replace=False)
            split_dataset = Subset(dataset, index_current.tolist())
            memory_data, index_list = self.rehearsal_memory(
                taski, total_num=memory_num * taski, index_array=index_list)
            self._add_loader(ConcatDataset([memory_data, split_dataset]), self.opt.batch_size)
        elif memory == "total":
            total_list = [dataset]
            for i in range(taski):
                total_list.append(self.create_dataset(data_list=self.select_data, taski=i))
            self._add_loader(ConcatDataset(total_list), self.opt.batch_size)
        elif memory is not None:
            # two half-batch loaders, the memory's first
            memory_data, index_list = self.rehearsal_memory(
                taski, total_num=memory_num, index_array=index_list)
            self._add_loader(memory_data, self.opt.batch_size // 2)
            self._add_loader(dataset, self.opt.batch_size // 2)
        else:
            self._add_loader(dataset)
        return index_list

    def rehearsal_memory(self, taski, total_num=2000, index_array=None, repeat=False):
        """Concat of each previous task's subset at its stored indices."""
        data_list = []
        for i in range(taski):
            ds = self.create_dataset(data_list=self.select_data, taski=i, repeat=repeat)
            data_list.append(Subset(ds, list(index_array[i])))
        return ConcatDataset(data_list), index_array

    def rehearsal_prev_model(self, taski):
        ds = self.create_dataset(data_list=self.select_data, taski=taski - 1, repeat=False)
        return None, len(ds)

    # -------------------------------------------------------- batching
    def get_batch(self):
        images, labels = [], []
        for loader in self.loaders:
            im, lb = loader.next_batch()
            images.append(im)
            labels += list(lb)
        return np.concatenate(images, 0), labels

    def get_batch2(self):
        images, labels, idxs = [], [], []
        for loader in self.loaders:
            im, lb, ix = loader.next_batch()
            images.append(im)
            labels += list(lb)
            idxs.append(ix)
        return np.concatenate(images, 0), labels, np.concatenate(idxs, 0)

    def skip_batches(self, n: int):
        """``n`` rounds of ``get_batch``'s draws without collating."""
        for _ in range(n):
            for loader in self.loaders:
                loader.skip_batch()


class ValDataset:
    def __init__(self, val_datas, opt, dataset_factory: Callable,
                 seed: Optional[int] = None):
        self.val_datas = list(val_datas)
        self.current_data = self.val_datas[-1]
        self.opt = opt
        self.rng = np.random.default_rng(opt.manual_seed if seed is None else seed)
        self._factory = dataset_factory

    def _loader(self, dataset) -> EpochLoader:
        return EpochLoader(dataset, self.opt.batch_size, shuffle=False, pad_to_batch=True,
                           rng=self.rng)

    def create_dataset(self, val_data=None) -> EpochLoader:
        return self._loader(self._factory(val_data or self.current_data))

    def create_list_dataset(self, valid_datas=None) -> EpochLoader:
        concat = []
        for val_data in (valid_datas or self.val_datas):
            ds = self._factory(val_data)
            if len(ds) > LIST_CAP:
                idx = self.rng.choice(len(ds), LIST_CAP, replace=False)
                ds = Subset(ds, idx.tolist())
            concat.append(ds)
        return self._loader(ConcatDataset(concat))
