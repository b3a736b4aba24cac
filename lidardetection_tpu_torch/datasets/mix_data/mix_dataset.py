"""The mixed-source dataset (copy of lidardetection_tpu/datasets/mix_data/
mix_dataset.py): the Livox protocol over a tree that
``gen_mix_dataset.generate_mix_dataset`` mixes from a Livox tree and a
fake-lidar tree, with KITTI evaluation.

The generator writes x, y, z as float64, three a point (it drops the Livox
intensity, and fake-lidar clouds have none). The JAX package's MixDataset
is a LivoxDataset and reads four a point, so it reads its own generator's
clouds with their coordinates shifted across rows (and raises where 3N is
not a multiple of 4). This one reads them three a point and gives every
point a zero intensity, the config's fourth feature.
"""

import numpy as np

from ..livox.livox_dataset import LivoxDataset


class MixDataset(LivoxDataset):
    STACK_FRAME_SIZE = 1
    BASE_FRAME_IDX = 0

    def get_lidar(self, idx):
        lidar_file = self.root_split_path / 'pointcloud' / f'{idx}.bin'
        assert lidar_file.exists(), lidar_file
        xyz = np.fromfile(str(lidar_file)).reshape(-1, 3)
        points = np.zeros((len(xyz), 4), np.float32)
        points[:, :3] = xyz
        return points
