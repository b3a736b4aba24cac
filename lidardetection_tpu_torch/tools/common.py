"""What the tools share: the device a tool runs on, its config, its detector
with a checkpoint's weights, the frames it reads and one eval step a
frame.

A tool runs on the card; ``--cpu`` (``tool_device(cpu=True)``) selects
the CPU, and without CUDA a tool given no ``--cpu`` raises. A detector's
weights are drawn from a seed unless a checkpoint of the port's is given
(``checkpoint_epoch_<n>.pth``, or the newest in a directory: the JAX
package's orbax checkpoints are not read). Frames come from a folder (or
one file) of ``.bin`` / ``.npy`` clouds through ``DemoDataset``, or are
synthetic scenes made from a seed (``build_test_loader``'s scenes, in
order); a ``Frame`` carries the host batch of one cloud, the cloud and
its gt boxes.
"""

import argparse
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import cfg_from_list, cfg_from_yaml_file, dataset_info
from ..datasets.plusai.plusai_bag_dataset import DemoDataset
from ..datasets.synthetic import build_test_loader
from ..engine.evaluator import to_host
from ..models import build_network
from ..parallel.train_step import device_batch, make_eval_step
from ..utils.checkpoint import latest_checkpoint, restore_model

SEED = 0  # the weights of a detector without a checkpoint, the synthetic scenes


def tool_device(cpu=False):
    """torch.device('cpu') when asked, else the card; raises without CUDA."""
    if cpu:
        return torch.device('cpu')
    if not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available; pass --cpu to run on the '
                           'CPU')
    return torch.device('cuda')


def base_parser(description, cfg_file='tools/cfgs/kitti_models/pointpillar.yaml'):
    """The arguments every detecting tool takes."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument('--cfg_file', type=str, default=cfg_file)
    parser.add_argument('--ckpt', type=str, default=None,
                        help='a checkpoint_epoch_<n>.pth, or a directory of '
                        'them (the newest); omit for weights from the seed')
    parser.add_argument('--cpu', action='store_true', help='run on the CPU')
    return parser


def load_config(cfg_file, set_cfgs=None):
    cfg = cfg_from_yaml_file(cfg_file) if isinstance(cfg_file, str) else cfg_file
    if set_cfgs:
        cfg_from_list(set_cfgs, cfg)
    return cfg


def build_detector(cfg, device, ckpt=None, logger=None, seed=SEED):
    """The config's detector on `device` in eval mode, with the weights of
    `ckpt` (a .pth, or the newest in a directory) or drawn from `seed`."""
    classes = list(cfg['CLASS_NAMES'])
    model = build_network(cfg['MODEL'], len(classes),
                          dataset_info(cfg['DATA_CONFIG']), seed=seed,
                          class_names=classes).to(device)
    if ckpt and ckpt != 'none':
        path = latest_checkpoint(ckpt) if Path(ckpt).is_dir() else ckpt
        if path is None:
            raise FileNotFoundError(f'no checkpoint_epoch_<n>.pth in {ckpt}')
        restore_model(path, model, logger)
    return model.eval()


def config_and_detector(args, logger=None):
    """A tool's config (``--cfg_file``) and its detector on the tool's
    device (``--cpu``) with ``--ckpt``'s weights."""
    device = tool_device(args.cpu)
    cfg = load_config(args.cfg_file)
    return cfg, build_detector(cfg, device, args.ckpt, logger)


@dataclass
class Frame:
    """One cloud: its host batch (batch size 1), the cloud as read, its
    gt boxes (G, 7) where it has them, and its time stamp in s."""
    batch: dict
    points: np.ndarray
    gt_boxes: Optional[np.ndarray]
    timestamp: float


def synthetic_frames(cfg, num_scenes, seed=SEED):
    """The config's synthetic test scenes 0 .. num_scenes - 1, 0.1 s
    apart."""
    dataset, loader = build_test_loader(cfg, 1, num_scenes, seed=seed)
    for i in range(len(dataset)):
        item = dataset[i]
        gt = item[1]
        yield Frame(loader.collate([item]), item[0],
                    gt[gt[:, -1] > 0][:, :7], 0.1 * i)


def folder_frames(cfg, data_path, ext='.bin', logger=None):
    """The clouds of a folder (or one file), sorted by name, 0.1 s apart."""
    dataset = DemoDataset(cfg['DATA_CONFIG'], list(cfg['CLASS_NAMES']),
                          training=False, root_path=data_path, logger=logger,
                          ext=ext)
    if not len(dataset):
        raise FileNotFoundError(f'no *{ext} files under {data_path}')
    dataset.set_model(cfg['MODEL'])
    for i, path in enumerate(dataset.sample_file_list):
        points = np.fromfile(path, np.float32).reshape(-1, 4) \
            if ext == '.bin' else np.load(path)
        yield Frame(dataset.collate_batch([dataset[i]]), points, None, 0.1 * i)


def frames(cfg, data_path=None, num_scenes=4, ext='.bin', logger=None):
    """Folder frames when `data_path` is given, else synthetic scenes."""
    if data_path:
        return folder_frames(cfg, data_path, ext, logger)
    return synthetic_frames(cfg, num_scenes)


class Predictor:
    """One eval step a host batch (``make_eval_step``: the eval forward and
    post-processing), its predictions back on the host as numpy."""

    def __init__(self, model, cfg):
        self.device = next(model.parameters()).device
        self.step = make_eval_step(model, cfg['MODEL']['POST_PROCESSING'],
                                   len(cfg['CLASS_NAMES']))

    def predict(self, batch):
        return to_host(self.step(device_batch(batch, self.device)))


def timed(fn, *args):
    """fn(*args) and its host-clock milliseconds (the predictions are on
    the host when it returns)."""
    t0 = time.perf_counter()
    out = fn(*args)
    return out, (time.perf_counter() - t0) * 1e3
