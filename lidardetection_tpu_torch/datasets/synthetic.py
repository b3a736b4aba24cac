"""Synthetic LiDAR scenes (copy of lidardetection_tpu/datasets/synthetic.py
``make_scene`` and ``_beam_ground``): deterministic request clouds made
from a seed, for the server's CLI and the chip smoke run; `SyntheticScenes`,
the in-memory training set, and its loader; the eval side
(``SyntheticCalib``, ``kitti_anno_from_lidar``, the set's
``generate_prediction_dicts`` and ``evaluation``, and the test-mode loader
of ``build_test_loader``); and `SyntheticDataset`, the same scenes as a
``DatasetTemplate`` that ``datasets.build_dataloader`` builds for
``DATASET: SyntheticDataset`` (the JAX package's SyntheticDataset), which
the training and test CLIs' ``--synthetic`` read.

A config's data decides three things more (`scene_options`), as the JAX
package's SyntheticDataset reads them: with PRED_VELOCITY the gt boxes are
NuScenes' ``[..., heading, vx, vy]``; with STACK_FRAME_SIZE T each box has
its T frame poses, ``locations`` (G, T, 3) and ``rotations_y`` (G, T);
and points with more than 4 features (NuScenes' timestamp, the PlusAI
multiframe set's frame index) carry those columns as zeros, a key
frame's. The JAX package's scenes have 4 columns whatever the config, and
its point encoder slices the fifth into nothing, so its model runs at
width 4 on them (ROADMAP.md section 3); the port builds its first layers
at the config's width, as the reference does. `make_sweeps` stacks
several scans into one cloud as dense as a multi-sweep NuScenes scan.
"""

import warnings

import numpy as np

from ..config import dataset_info, raw_point_capacity, voxel_processor_cfg
from ..core import np_geometry as npg
from ..ops.sparse_plan import config_plan
from ..ops.voxelize import build_batch, build_point_batch
from .dataset import DatasetTemplate
from .processor.data_processor import mask_boxes_outside_range

BUCKET_GRANULARITY = 4096  # lidardetection_tpu/datasets/__init__.py:49

CLASS_SIZE = {
    'Car': (3.9, 1.6, 1.56),
    'Pedestrian': (0.8, 0.6, 1.73),
    'Cyclist': (1.76, 0.6, 1.73),
    'Truck': (6.4, 2.5, 3.5),
    'Tram': (11.2, 2.9, 4.0),
}
CLASS_Z = {'Car': -1.0, 'Pedestrian': -0.73, 'Cyclist': -0.73,
           'Truck': 0.0, 'Tram': 0.0}
_DEFAULT_SIZE, _DEFAULT_Z = (4.0, 1.8, 1.6), -1.0  # unknown class fallback


def _beam_ground(rng, point_cloud_range, num_ground):
    """Ground returns of a spinning lidar: concentric per-beam rings with
    range and height jitter, thinned by striding the azimuth order."""
    x1, y1, z1, x2, y2, z2 = (float(v) for v in point_cloud_range[:6])
    h = 1.73  # sensor height above ground
    elev = np.deg2rad(np.linspace(-24.9, -1.8, 64))  # beam elevations
    radii = h / np.tan(-elev)
    r_max = float(np.hypot(max(abs(x1), abs(x2)), max(abs(y1), abs(y2))))
    radii = radii[radii < r_max]
    dphi = np.deg2rad(0.2)  # sensor azimuth resolution
    phis = np.arange(-np.pi, np.pi, dphi)
    r = np.repeat(radii, len(phis))
    phi = np.tile(phis, len(radii))
    r = r * (1.0 + rng.randn(r.size) * 0.004)
    phi = phi + rng.randn(r.size) * (dphi * 0.1)
    x = r * np.cos(phi)
    y = r * np.sin(phi)
    inside = (x > x1) & (x < x2) & (y > y1) & (y < y2)
    x, y = x[inside], y[inside]
    if x.size > num_ground:
        step = x.size / num_ground
        keep = (np.arange(num_ground) * step).astype(np.int64)
        x, y = x[keep], y[keep]
    z = np.full_like(x, -h) + rng.randn(x.size) * 0.03
    inten = rng.rand(x.size)
    return np.stack([x, y, z, inten], axis=1)


def make_scene(rng, point_cloud_range, num_objects=8, points_per_obj=120,
               num_ground=18000, class_names=('Car', 'Pedestrian', 'Cyclist')):
    """One scene: beam-ring ground returns + points on object box surfaces.

    Args:
        rng: np.random.RandomState.
    Returns (points (N, 4) float32, gt_boxes (M, 7) float32, gt_names (M,)).
    """
    x1, y1, z1, x2, y2, z2 = point_cloud_range
    gt_boxes, gt_names, obj_points = [], [], []
    for _ in range(num_objects):
        name = class_names[rng.randint(len(class_names))]
        dx, dy, dz = CLASS_SIZE.get(name, _DEFAULT_SIZE)
        diag = float(np.hypot(dx, dy))
        # rejection-sample a placement that overlaps no earlier box
        for _attempt in range(50):
            cx = rng.uniform(x1 + 5, x2 - 5)
            cy = rng.uniform(y1 + 5, y2 - 5)
            ok = all(
                np.hypot(cx - b[0], cy - b[1])
                > (diag + np.hypot(b[3], b[4])) / 2 + 0.5
                for b in gt_boxes)
            if ok:
                break
        else:
            continue  # crowded range: drop the object rather than overlap
        cz = CLASS_Z.get(name, _DEFAULT_Z)
        heading = rng.uniform(-np.pi, np.pi)
        sx = rng.uniform(0.9, 1.15)
        box = [cx, cy, cz, dx * sx, dy * sx, dz * sx, heading]
        gt_boxes.append(box)
        gt_names.append(name)
        # points on the two visible faces + top, in the local frame
        n = points_per_obj
        u = rng.rand(n)
        v = rng.rand(n)
        face = rng.randint(0, 3, n)
        lx = np.where(face == 0, (u - 0.5) * dx,
                      np.where(face == 1, -dx / 2, (u - 0.5) * dx))
        ly = np.where(face == 0, -dy / 2,
                      np.where(face == 1, (u - 0.5) * dy,
                               (rng.rand(n) - 0.5) * dy))
        lz = np.where(face == 2, dz / 2, (v - 0.5) * dz)
        ca, sa = np.cos(heading), np.sin(heading)
        px = lx * ca - ly * sa + cx
        py = lx * sa + ly * ca + cy
        pz = lz * sx + cz
        inten = rng.rand(n).astype(np.float32)
        obj_points.append(np.stack([px, py, pz, inten], axis=1))

    ground = _beam_ground(rng, point_cloud_range, num_ground)
    points = np.concatenate([ground] + obj_points, axis=0).astype(np.float32)
    return points, np.array(gt_boxes, np.float32), np.array(gt_names)


def make_sweeps(rng, point_cloud_range, sweeps, num_ground=18000,
                class_names=('Car', 'Pedestrian', 'Cyclist')):
    """One cloud of `sweeps` scans (``make_scene`` each), the k-th moved
    back by 0.5 k m along x, as an ego vehicle's earlier sweeps lie at 10
    m/s, with a fifth column of its time lag, 0.05 k s (a 20 Hz lidar):
    NuScenes' multi-sweep input. The gt boxes are the key frame's (the
    first scan's). Returns (points (N, 5) float32, gt_boxes (M, 7),
    gt_names (M,))."""
    clouds = []
    for k in range(sweeps):
        points, boxes, names = make_scene(rng, point_cloud_range,
                                          num_ground=num_ground,
                                          class_names=class_names)
        if k == 0:
            gt_boxes, gt_names = boxes, names
        points[:, 0] -= 0.5 * k
        lag = np.full((len(points), 1), 0.05 * k, np.float32)
        clouds.append(np.concatenate([points, lag], axis=1))
    return np.concatenate(clouds, axis=0), gt_boxes, gt_names


def scene_options(data_cfg, num_point_features):
    """The `SyntheticScenes` options a DATA_CONFIG sets."""
    return {'num_point_features': int(num_point_features),
            'pred_velocity': bool(data_cfg.get('PRED_VELOCITY', False)),
            'stack_frame_size': int(data_cfg.get('STACK_FRAME_SIZE', 0))}


def pad_gt_boxes(gt_boxes, gt_names, class_names, point_cloud_range,
                 max_gt_boxes=64, in_range_only=True, side=None):
    """Ground truth of one scene: (max_gt_boxes, D + 1) float32 for (M, D)
    boxes, the 1-based class id last and 0 marking a padding row. Boxes of
    other classes are dropped, and with `in_range_only` (training) those
    wholly outside the range too; test mode keeps them, as the JAX
    package's ``DatasetTemplate.prepare_data`` does. `side`, a dict of
    per-box arrays (the multiframe ``locations`` and ``rotations_y``), is
    cut and padded alike and returned beside the boxes."""
    keep = np.array([n in class_names for n in gt_names], dtype=bool)
    if keep.any() and in_range_only:
        keep[keep] = mask_boxes_outside_range(gt_boxes[keep],
                                              point_cloud_range)
    classes = np.array([class_names.index(n) + 1 for n in gt_names[keep]],
                       np.float32)
    d = gt_boxes.shape[1] if gt_boxes.ndim == 2 else 7
    out = np.zeros((max_gt_boxes, d + 1), np.float32)
    n = min(int(keep.sum()), max_gt_boxes)
    out[:n, :d] = gt_boxes.reshape(-1, d)[keep][:n]
    out[:n, d] = classes[:n]
    if side is None:
        return out
    padded = {}
    for key, arr in side.items():
        padded[key] = np.zeros((max_gt_boxes,) + arr.shape[1:], np.float32)
        padded[key][:n] = arr[keep][:n]
    return out, padded


class SyntheticScenes:
    """In-memory set of `num_scenes` scenes made from `seed` (scene i from
    ``RandomState(seed * 100003 + i)``, as the JAX package's
    SyntheticDataset draws them, its velocities and frame poses after the
    scene). Items are ``(points (N, F), gt_boxes (max_gt_boxes, D + 1))``
    with F = `num_point_features` and D 7, or 9 with `pred_velocity`; with
    `stack_frame_size` a training item carries a third entry, ``{'locations':
    (max_gt_boxes, T, 3), 'rotations_y': (max_gt_boxes, T)}``. In test
    mode (``training=False``) gt boxes outside the range are kept and an
    item carries its index, the frame id, third: ``(points, gt_boxes,
    frame_id)``. No augmentation."""

    def __init__(self, class_names, point_cloud_range, num_scenes=64, seed=0,
                 max_gt_boxes=64, training=True, num_point_features=4,
                 pred_velocity=False, stack_frame_size=0):
        self.class_names = tuple(class_names)
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self.num_scenes, self.seed = num_scenes, seed
        self.max_gt_boxes, self.training = max_gt_boxes, training
        self.num_point_features = num_point_features
        self.pred_velocity, self.stack_frame_size = pred_velocity, stack_frame_size

    def __len__(self):
        return self.num_scenes

    def scene(self, index):
        """Scene `index`: (points (N, 4), gt_boxes (M, 7), gt_names (M,))."""
        return self._draw(index)[:3]

    def _draw(self, index):
        rng = np.random.RandomState(self.seed * 100003 + index)
        points, gt_boxes, gt_names = make_scene(
            rng, self.point_cloud_range, class_names=self.class_names)
        return points, gt_boxes, gt_names, rng

    def sample(self, index):
        """Scene `index` as the config's data holds it: points with
        `num_point_features` columns, gt boxes with the velocity columns
        when asked for, and the frame poses (a dict, or None)."""
        points, gt_boxes, gt_names, rng = self._draw(index)
        if self.pred_velocity:
            vel = (rng.randn(len(gt_boxes), 2) * 2.0).astype(np.float32)
            gt_boxes = np.concatenate([gt_boxes.reshape(-1, 7), vel], axis=1)
        side = None
        if self.stack_frame_size > 0:
            t, n = self.stack_frame_size, len(gt_boxes)
            vel = rng.randn(n, 2) * 1.0  # m a frame
            locations = np.repeat(gt_boxes.reshape(n, -1)[:, None, 0:3], t,
                                  axis=1)
            for i in range(t):
                locations[:, i, 0:2] -= vel * (t - 1 - i)
            side = {'locations': locations.astype(np.float32),
                    'rotations_y': np.repeat(gt_boxes.reshape(n, -1)[:, None, 6],
                                             t, axis=1).astype(np.float32)}
        extra = self.num_point_features - points.shape[1]
        if extra > 0:
            points = np.concatenate(
                [points, np.zeros((len(points), extra), np.float32)], axis=1)
        return points, gt_boxes, gt_names, side

    def __getitem__(self, index):
        points, gt_boxes, gt_names, side = self.sample(index)
        gt = pad_gt_boxes(gt_boxes, gt_names, self.class_names,
                          self.point_cloud_range, self.max_gt_boxes,
                          in_range_only=self.training, side=side)
        if not self.training:
            return (points, gt if side is None else gt[0], index)
        return (points, gt) if side is None else (points, *gt)

    def generate_prediction_dicts(self, batch_dict, pred_dicts, class_names):
        """KITTI annos of a batch's kept detections (numpy `pred_dicts`,
        padded, the kept rows marked by ``pred_mask``: the multi-class NMS
        leaves gaps between them)."""
        annos = []
        for i in range(batch_dict['batch_size']):
            kept = np.asarray(pred_dicts['pred_mask'][i], bool)
            boxes = np.asarray(pred_dicts['pred_boxes'][i][kept])[:, :7]
            labels = np.asarray(pred_dicts['pred_labels'][i][kept]).astype(int)
            names = np.array([class_names[l - 1] for l in labels])
            scores = np.asarray(pred_dicts['pred_scores'][i][kept])
            anno = kitti_anno_from_lidar(boxes, names, scores)
            anno['frame_id'] = batch_dict['frame_id'][i]
            annos.append(anno)
        return annos

    def evaluation(self, det_annos, class_names, **kwargs):
        """Official KITTI-protocol AP against the generating gt boxes, each
        frame's remade from its seed."""
        from .kitti.kitti_object_eval import eval as kitti_eval

        gt_annos = []
        for det in det_annos:
            _, gt_boxes, gt_names = self.scene(int(det['frame_id']))
            gt_annos.append(kitti_anno_from_lidar(gt_boxes, gt_names))
        return kitti_eval.get_official_eval_result(
            gt_annos, det_annos, class_names)


class SyntheticDataset(DatasetTemplate):
    """The synthetic scenes as a dataset of the registry (``DATASET:
    SyntheticDataset``; the JAX package's SyntheticDataset,
    datasets/synthetic.py:116-191): `num_scenes` scenes from `seed`, scene
    i drawn by `SyntheticScenes.sample` (``RandomState(seed * 100003 +
    i)``, the velocities and frame poses after the scene), its points
    with the zero columns that the source feature list asks for, then
    ``prepare_data`` (augmentor, filters, processors, host plan, padding)
    with the loader's generator. The frame id is the scene's index."""

    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, num_scenes=64, seed=0):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names,
                         training=training, root_path=root_path or '.',
                         logger=logger, seed=seed)
        width = len(dataset_cfg['POINT_FEATURE_ENCODING']['src_feature_list'])
        self.scenes = SyntheticScenes(
            class_names, self.point_cloud_range, num_scenes=num_scenes,
            seed=seed, **scene_options(dataset_cfg, width))

    def __len__(self):
        return len(self.scenes)

    def get_item(self, index, rng):
        points, gt_boxes, gt_names, side = self.scenes.sample(index)
        data_dict = {'points': points, 'gt_boxes': gt_boxes,
                     'gt_names': gt_names, 'frame_id': index, **(side or {})}
        return self.prepare_data(data_dict, rng)

    def generate_prediction_dicts(self, batch_dict, pred_dicts, class_names,
                                  output_path=None):
        return self.scenes.generate_prediction_dicts(batch_dict, pred_dicts,
                                                     class_names)

    def evaluation(self, det_annos, class_names, **kwargs):
        return self.scenes.evaluation(det_annos, class_names)


class SyntheticLoader:
    """Batches of a dataset, collated by `collate` (``Trainer.make_batch``,
    or the test-mode collate of ``build_test_loader``). Drops the last
    partial batch when `drop_last`; the order is reshuffled per epoch from
    `seed` when `shuffle`."""

    def __init__(self, dataset, batch_size, collate, shuffle=True, seed=0,
                 drop_last=True):
        self.dataset, self.batch_size, self.collate = dataset, batch_size, collate
        self.shuffle, self.seed, self.epoch = shuffle, seed, 0
        self.drop_last = drop_last

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return len(self.dataset) // self.batch_size
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        for i in range(len(self)):
            ids = order[i * self.batch_size:(i + 1) * self.batch_size]
            yield self.collate([self.dataset[j] for j in ids])


def bucket_voxels(batch, plan):
    """Lossless occupancy bucketing of an eval batch, in place (the JAX
    package's ``DataLoader._bucket``, datasets/__init__.py:69-92): the voxel
    table is cut to the batch's largest ``num_voxels`` rounded up to
    BUCKET_GRANULARITY (at most the capacity), and with a host `plan` every
    later stage's table the same way by its ``rb_<name>_num``. Tables are
    sorted with the padding at the tail, so only padding goes. Rulebook
    values are clamped to the new capacity of the table they index, so a
    miss stays equal to it. Returns the batch."""
    cap = batch['voxels'].shape[1]

    def cut(num, capacity):
        g = BUCKET_GRANULARITY
        m = -(-max(1, int(num.max())) // g) * g
        return min(m, capacity)

    m = cut(batch['num_voxels'], cap)
    if m < cap:
        for key in ('voxels', 'voxel_coords', 'voxel_num_points'):
            batch[key] = np.ascontiguousarray(batch[key][:, :m])
    if plan is not None and f'rb_{plan.ops[0].name}' in batch:
        stages, rows, values = plan.bucket_spec()
        m_stage = [m] + [cut(batch[num_key], capacity)
                         for num_key, capacity in stages[1:]]
        for key, stage in rows:
            if m_stage[stage] < batch[key].shape[1]:
                batch[key] = np.ascontiguousarray(batch[key][:, :m_stage[stage]])
        for key, stage in values:
            np.minimum(batch[key], np.int32(m_stage[stage]), out=batch[key])
    return batch


def build_test_loader(cfg, batch_size, num_scenes, seed=0):
    """The test-mode set and loader of a config (the JAX package's
    ``build_dataloader(training=False, model_cfg=...)`` on its synthetic
    set): scenes in order, every one of them, points not shuffled,
    voxelized on the host at the config's ``test`` cap. A batch is a dict
    of numpy arrays: the voxel table, the host plan's ``rb_*`` tables for a
    model with a sparse 3D backbone (``ops/sparse_plan.py::config_plan``),
    the raw ``points`` / ``num_points`` padded to MAX_POINTS when the model
    reads them (``config.raw_point_capacity``), the padded ``gt_boxes``
    that the recall counters read, ``frame_id`` and ``batch_size``. Unless
    DATA_CONFIG.VOXEL_BUCKETING is false, the tables are cut to the
    batch's occupancy (`bucket_voxels`). Warns when a scene fills the cap:
    the table then keeps the first voxels in scan order, a spatially
    biased crop. A point-based config (PointRCNN) has no voxel table: its
    clouds go through the test split's processors
    (``ops/voxelize.py::build_point_batch``), the sample drawn from
    ``RandomState([seed, *frame ids])``, so a batch is the same on every
    pass."""
    data_cfg = cfg['DATA_CONFIG']
    info = dataset_info(data_cfg)
    vox = voxel_processor_cfg(data_cfg)
    plan = config_plan(cfg, training=False)
    bucketing = bool(data_cfg.get('VOXEL_BUCKETING', True))
    dataset = SyntheticScenes(
        cfg['CLASS_NAMES'], info['point_cloud_range'], num_scenes=num_scenes,
        seed=seed, max_gt_boxes=int(data_cfg.get('MAX_GT_BOXES', 64)),
        training=False,
        **scene_options(data_cfg, info['num_point_features']))

    def voxels(items):
        max_voxels = int(vox['MAX_NUMBER_OF_VOXELS']['test'])
        batch = build_batch([points for points, _, _ in items],
                            info['point_cloud_range'], info['voxel_size'],
                            int(vox['MAX_POINTS_PER_VOXEL']), max_voxels,
                            max_points=raw_point_capacity(cfg), plan=plan)
        if (batch['num_voxels'] >= max_voxels).any():
            warnings.warn(f'MAX_NUMBER_OF_VOXELS[test]={max_voxels} saturated: '
                          f'eval truncation keeps the first voxels in scan '
                          f'order and can zero AP; raise the cap',
                          RuntimeWarning, stacklevel=2)
        if bucketing:
            bucket_voxels(batch, plan)
        return batch

    def collate(items):
        if vox is None:
            batch = build_point_batch(
                [points for points, _, _ in items], data_cfg['DATA_PROCESSOR'],
                info['point_cloud_range'], raw_point_capacity(cfg),
                training=False,
                rng=np.random.RandomState([seed] + [i for _, _, i in items]))
        else:
            batch = voxels(items)
        batch['gt_boxes'] = np.stack([gt for _, gt, _ in items])
        batch['frame_id'] = np.array([i for _, _, i in items])
        batch['batch_size'] = len(items)
        return batch

    return dataset, SyntheticLoader(dataset, batch_size, collate,
                                    shuffle=False, drop_last=False)


class SyntheticCalib:
    """Canonical lidar->rect mapping (x_c=-y_l, y_c=-z_l, z_c=x_l) plus a
    wide synthetic pinhole (f=1000, 2000x6000 image) so boxes anywhere in
    the point-cloud range project to image bboxes large enough for the
    KITTI difficulty gates (MIN_HEIGHT 40/25/25 px of the protocol)."""

    IMAGE_SHAPE = (2000, 6000)  # (H, W)

    def __init__(self):
        self.V2C = np.array([[0., -1., 0., 0.],
                             [0., 0., -1., 0.],
                             [1., 0., 0., 0.]])
        self.R0 = np.eye(3)
        self.P2 = np.array([[1000., 0., 3000., 0.],
                            [0., 1000., 1000., 0.],
                            [0., 0., 1., 0.]])

    def lidar_to_rect(self, pts_lidar):
        hom = np.concatenate(
            [pts_lidar, np.ones((pts_lidar.shape[0], 1))], axis=1)
        return hom @ (self.V2C.T @ self.R0.T)

    def rect_to_img(self, pts_rect):
        hom = np.concatenate(
            [pts_rect, np.ones((pts_rect.shape[0], 1))], axis=1)
        p = hom @ self.P2.T
        z = np.maximum(p[:, 2], 0.1)  # clamp behind-camera points
        img = p[:, 0:2] / z[:, None]
        return img, p[:, 2] - self.P2.T[3, 2]


def kitti_anno_from_lidar(boxes_lidar, names, scores=None):
    """Lidar boxes (N, 7) -> full KITTI camera-protocol anno dict."""
    calib = SyntheticCalib()
    n = len(boxes_lidar)
    boxes_lidar = np.asarray(boxes_lidar, np.float64).reshape(n, 7)
    if n:
        cam = npg.boxes3d_lidar_to_kitti_camera(boxes_lidar, calib)
        bbox = npg.boxes3d_kitti_camera_to_imageboxes(
            cam, calib, image_shape=SyntheticCalib.IMAGE_SHAPE)
        alpha = (-np.arctan2(-boxes_lidar[:, 1], boxes_lidar[:, 0])
                 + cam[:, 6])
    else:
        cam = np.zeros((0, 7))
        bbox = np.zeros((0, 4))
        alpha = np.zeros(0)
    return {
        'name': np.asarray(names),
        'truncated': np.zeros(n),
        'occluded': np.zeros(n, np.int64),
        'alpha': alpha,
        'bbox': bbox,
        'dimensions': cam[:, 3:6],
        'location': cam[:, 0:3],
        'rotation_y': cam[:, 6],
        'score': (np.asarray(scores) if scores is not None
                  else np.ones(n)),
        'boxes_lidar': boxes_lidar,
    }
