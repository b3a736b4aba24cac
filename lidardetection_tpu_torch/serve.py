"""Serving (PointPillar and SECOND): the port's entry point.

``Detector(cfg_file, device="cuda", seed=0, state_dict=None)`` builds the
detector of a YAML config (or of a loaded config) on the card; parameters
are drawn from ``seed`` unless a ``state_dict`` (for example from
``convert.flax_to_state_dict``) is given. ``Detector.predict(points_list)``
answers one request per cloud (batch 1, as tools/inference.py serves) and
returns a list of ``{boxes (n, 7), scores (n,), labels (n,)}`` numpy dicts.

The CPU is used only when asked (``device="cpu"``); the default device
raises when CUDA is absent.

CLI, answering requests on synthetic scenes made from ``--seed``:

    python -m lidardetection_tpu_torch.serve \\
        --cfg_file tools/cfgs/kitti_models/second.yaml --num_requests 8
"""

import argparse
import time

import numpy as np
import torch

from .config import cfg_from_yaml_file, dataset_info, voxel_processor_cfg
from .datasets.synthetic import make_scene
from .models import build_network
from .models.detectors.post_processing import post_processing
from .ops.voxelize import build_batch


class Detector:
    def __init__(self, cfg_file, device='cuda', seed=0, state_dict=None):
        device = torch.device(device)
        if device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('CUDA is not available; pass device="cpu" to '
                               'run on the CPU')
        self.cfg = cfg_file if isinstance(cfg_file, dict) \
            else cfg_from_yaml_file(cfg_file)
        self.device = device
        data_cfg = self.cfg['DATA_CONFIG']
        self.info = dataset_info(data_cfg)
        vox = voxel_processor_cfg(data_cfg)
        self.max_points_per_voxel = int(vox['MAX_POINTS_PER_VOXEL'])
        self.max_voxels = int(vox['MAX_NUMBER_OF_VOXELS']['test'])
        self.num_class = len(self.cfg['CLASS_NAMES'])
        self.model = build_network(self.cfg['MODEL'], self.num_class,
                                   self.info, seed=seed)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.model.to(device)

    def make_batch(self, points_list):
        """Voxelize clouds on the host; the batch tensors on the device."""
        arrays = build_batch(points_list, self.info['point_cloud_range'],
                             self.info['voxel_size'],
                             self.max_points_per_voxel, self.max_voxels)
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in arrays.items()}

    @torch.inference_mode()
    def forward(self, batch):
        """Model forward: the head output with ``batch_fused_preds``."""
        return self.model(batch)

    @torch.inference_mode()
    def postprocess(self, out):
        return post_processing(out, self.cfg['MODEL']['POST_PROCESSING'],
                               self.num_class)

    def predict(self, points_list):
        """One request per (N, 4) cloud; returns numpy detections."""
        results = []
        for points in points_list:
            preds = self.postprocess(self.forward(self.make_batch([points])))
            n = int(preds['num_preds'][0])
            results.append({
                'boxes': preds['pred_boxes'][0, :n].cpu().numpy(),
                'scores': preds['pred_scores'][0, :n].cpu().numpy(),
                'labels': preds['pred_labels'][0, :n].cpu().numpy(),
            })
        return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--cfg_file', default='tools/cfgs/kitti_models/pointpillar.yaml')
    parser.add_argument('--num_requests', type=int, default=4)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)

    detector = Detector(args.cfg_file, device=args.device, seed=args.seed)
    rng = np.random.RandomState(args.seed)
    pc_range = np.asarray(detector.info['point_cloud_range'], np.float32)
    for i in range(args.num_requests):
        points, _, _ = make_scene(
            rng, pc_range, class_names=tuple(detector.cfg['CLASS_NAMES']))
        t0 = time.perf_counter()
        result = detector.predict([points])[0]
        ms = (time.perf_counter() - t0) * 1e3
        print(f'request {i}: {len(points)} points -> '
              f'{len(result["boxes"])} detections in {ms:.1f} ms '
              f'({args.device})', flush=True)


if __name__ == '__main__':
    main()
