"""Official KITTI object detection evaluation (bbox / BEV / 3D / AOS AP).

A copy of lidardetection_tpu/datasets/kitti/kitti_object_eval/eval.py
(itself the protocol of pcdet/datasets/kitti/kitti_object_eval_python/
eval.py, numba-free), pointed at the port's own ``core/np_geometry.py``
and ``native/``. The rotated IoU and the matching loops run in the native
host library (``native/rotated_iou.cpp``, ``native/kitti_stats.cpp``); the
numpy code here and in ``np_geometry`` is their plain version, taken only
when the caller asks for it (``native.plain_host()`` or
``LIDARDET_TORCH_PLAIN_HOST=1``). Both give the same results.

Annotation dicts follow the KITTI convention: name, truncated, occluded,
alpha, bbox (N, 4), dimensions (N, 3)[l, h, w], location (N, 3) camera,
rotation_y, score (dt only).
"""

import io as sysio

import numpy as np

from .... import native
from ....core.np_geometry import boxes_bev_iou_cpu


def get_thresholds(scores, num_gt, num_sample_pts=41):
    """Score thresholds at ~uniform recall steps (eval.py:9-27)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) \
                and (i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


CLASS_NAMES_EVAL = ['car', 'pedestrian', 'cyclist', 'van', 'person_sitting', 'truck']
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]


def clean_data(gt_anno, dt_anno, current_class, difficulty):
    """Difficulty filtering + neighboring-class ignores (eval.py:30-85)."""
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    current_cls_name = CLASS_NAMES_EVAL[current_class]
    num_gt = len(gt_anno['name'])
    num_dt = len(dt_anno['name'])
    num_valid_gt = 0
    for i in range(num_gt):
        bbox = gt_anno['bbox'][i]
        gt_name = str(gt_anno['name'][i]).lower()
        height = bbox[3] - bbox[1]
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == 'pedestrian' and gt_name == 'person_sitting':
            valid_class = 0
        elif current_cls_name == 'car' and gt_name == 'van':
            valid_class = 0
        else:
            valid_class = -1
        ignore = (gt_anno['occluded'][i] > MAX_OCCLUSION[difficulty]
                  or gt_anno['truncated'][i] > MAX_TRUNCATION[difficulty]
                  or height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if str(gt_anno['name'][i]) == 'DontCare':
            dc_bboxes.append(gt_anno['bbox'][i])
    for i in range(num_dt):
        valid_class = 1 if str(dt_anno['name'][i]).lower() == current_cls_name else -1
        height = abs(dt_anno['bbox'][i, 3] - dt_anno['bbox'][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """2D image-box IoU with area criterion (eval.py:88-115), vectorized."""
    n, k = boxes.shape[0], query_boxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]))
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]))
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    area_b = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))[:, None]
    area_q = ((query_boxes[:, 2] - query_boxes[:, 0])
              * (query_boxes[:, 3] - query_boxes[:, 1]))[None, :]
    if criterion == -1:
        ua = area_b + area_q - inter
    elif criterion == 0:
        ua = np.broadcast_to(area_b, inter.shape).copy()
    elif criterion == 1:
        ua = np.broadcast_to(area_q, inter.shape).copy()
    else:
        ua = np.ones_like(inter)
    return np.where(inter > 0, inter / ua, 0.0)


def _rotated_overlap_area(boxes, qboxes):
    """Rotated rectangle intersection area for (x, z, l, w, ry) camera-plane
    boxes (replaces rotate_iou_gpu_eval criterion=2)."""
    n, m = boxes.shape[0], qboxes.shape[0]
    if n == 0 or m == 0:
        return np.zeros((n, m))
    to7 = lambda b: np.stack(
        [b[:, 0], b[:, 1], np.zeros(len(b)), b[:, 2], b[:, 3],
         np.ones(len(b)), b[:, 4]], axis=1)
    a7, b7 = to7(boxes), to7(qboxes)
    iou = boxes_bev_iou_cpu(a7, b7)  # criterion -1
    area_a = (boxes[:, 2] * boxes[:, 3])[:, None]
    area_b = (qboxes[:, 2] * qboxes[:, 3])[None, :]
    # invert IoU back to intersection area: i = iou*(A+B)/(1+iou)
    return iou * (area_a + area_b) / (1.0 + iou)


def bev_box_overlap(boxes, qboxes, criterion=-1):
    """(x, z, l, w, ry) rotated IoU (eval.py:118-120)."""
    inter = _rotated_overlap_area(boxes, qboxes)
    area_b = (boxes[:, 2] * boxes[:, 3])[:, None]
    area_q = (qboxes[:, 2] * qboxes[:, 3])[None, :]
    if criterion == -1:
        ua = area_b + area_q - inter
    elif criterion == 0:
        ua = np.broadcast_to(area_b, inter.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area_q, inter.shape)
    else:
        ua = np.ones_like(inter)
    return inter / np.maximum(ua, 1e-12)


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """Camera-frame 3D IoU (eval.py:123-155): BEV footprint x y-extent.

    boxes: (N, 7) [x, y, z, l, h, w, ry] camera coords, y = box bottom.
    """
    rinc = _rotated_overlap_area(boxes[:, [0, 2, 3, 5, 6]],
                                 qboxes[:, [0, 2, 3, 5, 6]])
    n, m = boxes.shape[0], qboxes.shape[0]
    if n == 0 or m == 0:
        return rinc
    # y extent: [y - h, y] (camera y points down; location y is bottom)
    iw = (np.minimum(boxes[:, None, 1], qboxes[None, :, 1])
          - np.maximum(boxes[:, None, 1] - boxes[:, None, 4],
                       qboxes[None, :, 1] - qboxes[None, :, 4]))
    vol_b = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    vol_q = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    inc = np.where(iw > 0, iw * rinc, 0.0)
    if criterion == -1:
        ua = vol_b + vol_q - inc
    elif criterion == 0:
        ua = np.broadcast_to(vol_b, inc.shape)
    elif criterion == 1:
        ua = np.broadcast_to(vol_q, inc.shape)
    else:
        ua = np.maximum(inc, 1e-12)
    return np.where((rinc > 0) & (iw > 0), inc / np.maximum(ua, 1e-12), 0.0)


NO_DETECTION = -10000000


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """Per-image TP/FP/FN under the official matching rules (eval.py:157-287).

    overlaps: (num_dt, num_gt) — note dt-major like the reference call site.
    """
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned_detection = [False] * det_size
    ignored_threshold = [dt_scores[i] < thresh if compute_fp else False
                         for i in range(det_size)]
    tp = fp = fn = 0
    similarity = 0.0
    thresholds = []
    delta = []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned_detection[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if (not compute_fp and overlap > min_overlap
                    and dt_score > valid_detection):
                det_idx = j
                valid_detection = dt_score
            elif (compute_fp and overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored_det)
                  and ignored_det[j] == 0):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (compute_fp and overlap > min_overlap
                  and valid_detection == NO_DETECTION and ignored_det[j] == 1):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True

        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION and (
                ignored_gt[i] == 1 or ignored_det[det_idx] == 1):
            assigned_detection[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned_detection[det_idx] = True

    if compute_fp:
        for i in range(det_size):
            if not (assigned_detection[i] or ignored_det[i] in (-1, 1)
                    or ignored_threshold[i]):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes) > 0:
            overlaps_dt_dc = image_box_overlap(dt_bboxes, np.asarray(dc_bboxes), 0)
            for i in range(len(dc_bboxes)):
                for j in range(det_size):
                    if (assigned_detection[j] or ignored_det[j] in (-1, 1)
                            or ignored_threshold[j]):
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        assigned_detection[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = [0.0] * fp + [(1.0 + np.cos(d)) / 2.0 for d in delta]
            similarity = float(np.sum(tmp)) if (tp > 0 or fp > 0) else -1
    return tp, fp, fn, similarity, np.asarray(thresholds)


def _calculate_iou(gt_annos, dt_annos, metric):
    """Per-image overlap matrices (calculate_iou_partly, eval.py:340-415,
    without the partitioning — pure numpy needs no GPU batching)."""
    overlaps = []
    for gt, dt in zip(gt_annos, dt_annos):
        if metric == 0:
            o = image_box_overlap(dt['bbox'], gt['bbox'])
        elif metric == 1:
            def bev5(a):
                return np.concatenate(
                    [a['location'][:, [0, 2]], a['dimensions'][:, [0, 2]],
                     a['rotation_y'][..., None]], axis=1)
            o = bev_box_overlap(bev5(dt), bev5(gt))
        elif metric == 2:
            def cam7(a):
                return np.concatenate(
                    [a['location'], a['dimensions'], a['rotation_y'][..., None]],
                    axis=1)
            o = d3_box_overlap(cam7(dt), cam7(gt))
        else:
            raise ValueError(metric)
        overlaps.append(o.astype(np.float64))
    return overlaps


def _prepare_data(gt_annos, dt_annos, current_class, difficulty):
    """(eval.py:417-452)."""
    gt_datas_list, dt_datas_list = [], []
    ignored_gts, ignored_dets, dontcares = [], [], []
    total_num_valid_gt = 0
    for gt, dt in zip(gt_annos, dt_annos):
        num_valid_gt, ignored_gt, ignored_det, dc_bboxes = clean_data(
            gt, dt, current_class, difficulty)
        ignored_gts.append(np.array(ignored_gt, np.int64))
        ignored_dets.append(np.array(ignored_det, np.int64))
        dontcares.append(np.stack(dc_bboxes, 0).astype(np.float64)
                         if dc_bboxes else np.zeros((0, 4)))
        total_num_valid_gt += num_valid_gt
        gt_datas_list.append(np.concatenate(
            [gt['bbox'], gt['alpha'][..., None]], 1))
        dt_datas_list.append(np.concatenate(
            [dt['bbox'], dt['alpha'][..., None], dt['score'][..., None]], 1))
    return (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
            dontcares, total_num_valid_gt)


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False):
    """(eval.py:448-545). min_overlaps: [num_minoverlap, metric, class]."""
    assert len(gt_annos) == len(dt_annos)
    overlaps = _calculate_iou(gt_annos, dt_annos, metric)
    n_sample_pts = 41
    num_minoverlap = len(min_overlaps)
    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    precision = np.zeros([num_class, num_difficulty, num_minoverlap, n_sample_pts])
    recall = np.zeros_like(precision)
    aos = np.zeros_like(precision)

    for m, current_class in enumerate(current_classes):
        for l, difficulty in enumerate(difficultys):
            (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
             dontcares, total_num_valid_gt) = _prepare_data(
                gt_annos, dt_annos, current_class, difficulty)
            use_native = not native.plain_requested()
            for k in range(min_overlaps.shape[0]):
                min_overlap = min_overlaps[k, metric, m]
                thresholdss = []
                for i in range(len(gt_annos)):
                    if use_native:
                        th = native.kitti_tp_scores(
                            overlaps[i], dt_datas_list[i][:, -1],
                            ignored_gts[i], ignored_dets[i], min_overlap)
                    else:
                        _, _, _, _, th = compute_statistics(
                            overlaps[i], gt_datas_list[i], dt_datas_list[i],
                            ignored_gts[i], ignored_dets[i], dontcares[i],
                            metric, min_overlap=min_overlap, thresh=0.0,
                            compute_fp=False)
                    thresholdss += th.tolist()
                thresholds = np.array(get_thresholds(
                    np.array(thresholdss), total_num_valid_gt))
                pr = np.zeros([len(thresholds), 4])
                for i in range(len(gt_annos)):
                    if use_native and len(thresholds):
                        # threshold-fused C++ matcher (the reference's
                        # fused_compute_statistics role, eval.py:291);
                        # semantics identical to the Python loop below
                        dt_dc = None
                        if metric == 0 and len(dontcares[i]) > 0:
                            dt_dc = image_box_overlap(
                                dt_datas_list[i][:, :4], dontcares[i], 0)
                        native.kitti_fused_stats(
                            overlaps[i], dt_datas_list[i][:, -1],
                            dt_datas_list[i][:, 4], gt_datas_list[i][:, 4],
                            dt_dc, ignored_gts[i], ignored_dets[i],
                            metric, min_overlap, thresholds, compute_aos, pr)
                        continue
                    for t, thresh in enumerate(thresholds):
                        tp, fp, fn, similarity, _ = compute_statistics(
                            overlaps[i], gt_datas_list[i], dt_datas_list[i],
                            ignored_gts[i], ignored_dets[i], dontcares[i],
                            metric, min_overlap=min_overlap, thresh=thresh,
                            compute_fp=True, compute_aos=compute_aos)
                        pr[t, 0] += tp
                        pr[t, 1] += fp
                        pr[t, 2] += fn
                        if similarity != -1:
                            pr[t, 3] += similarity
                for i in range(len(thresholds)):
                    recall[m, l, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                    precision[m, l, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                    if compute_aos:
                        aos[m, l, k, i] = pr[i, 3] / (pr[i, 0] + pr[i, 1])
                for i in range(len(thresholds)):
                    precision[m, l, k, i] = np.max(precision[m, l, k, i:], axis=-1)
                    recall[m, l, k, i] = np.max(recall[m, l, k, i:], axis=-1)
                    if compute_aos:
                        aos[m, l, k, i] = np.max(aos[m, l, k, i:], axis=-1)
    return {'recall': recall, 'precision': precision, 'orientation': aos}


def get_mAP(prec):
    """11-point AP (eval.py:548-552)."""
    sums = 0
    for i in range(0, prec.shape[-1], 4):
        sums = sums + prec[..., i]
    return sums / 11 * 100


def get_mAP_R40(prec):
    """R40 AP (eval.py:555-559)."""
    sums = 0
    for i in range(1, prec.shape[-1]):
        sums = sums + prec[..., i]
    return sums / 40 * 100


def print_str(value, *arg, sstream=None):
    if sstream is None:
        sstream = sysio.StringIO()
    sstream.truncate(0)
    sstream.seek(0)
    print(value, *arg, file=sstream)
    return sstream.getvalue()


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
            compute_aos=False, PR_detail_dict=None):
    """(eval.py:570-609)."""
    difficultys = [0, 1, 2]
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0,
                     min_overlaps, compute_aos)
    mAP_bbox = get_mAP(ret['precision'])
    mAP_bbox_R40 = get_mAP_R40(ret['precision'])
    if PR_detail_dict is not None:
        PR_detail_dict['bbox'] = ret['precision']
    mAP_aos = mAP_aos_R40 = None
    if compute_aos:
        mAP_aos = get_mAP(ret['orientation'])
        mAP_aos_R40 = get_mAP_R40(ret['orientation'])
        if PR_detail_dict is not None:
            PR_detail_dict['aos'] = ret['orientation']
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1,
                     min_overlaps)
    mAP_bev = get_mAP(ret['precision'])
    mAP_bev_R40 = get_mAP_R40(ret['precision'])
    if PR_detail_dict is not None:
        PR_detail_dict['bev'] = ret['precision']
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2,
                     min_overlaps)
    mAP_3d = get_mAP(ret['precision'])
    mAP_3d_R40 = get_mAP_R40(ret['precision'])
    if PR_detail_dict is not None:
        PR_detail_dict['3d'] = ret['precision']
    return (mAP_bbox, mAP_bev, mAP_3d, mAP_aos,
            mAP_bbox_R40, mAP_bev_R40, mAP_3d_R40, mAP_aos_R40)


CLASS_TO_NAME = {0: 'Car', 1: 'Pedestrian', 2: 'Cyclist', 3: 'Van',
                 4: 'Person_sitting', 5: 'Truck'}


def get_official_eval_result(gt_annos, dt_annos, current_classes,
                             PR_detail_dict=None):
    """(eval.py:639-720)."""
    overlap_0_7 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.7]] * 3)
    overlap_0_5 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25, 0.5]])
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], axis=0)  # [2, 3, 6]
    name_to_class = {v: n for n, v in CLASS_TO_NAME.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [name_to_class[c] if isinstance(c, str) else int(c)
                       for c in current_classes]
    min_overlaps = min_overlaps[:, :, current_classes]
    result = ''
    compute_aos = False
    for anno in dt_annos:
        if anno['alpha'].shape[0] != 0:
            if anno['alpha'][0] != -10:
                compute_aos = True
            break
    (mAPbbox, mAPbev, mAP3d, mAPaos, mAPbbox_R40, mAPbev_R40, mAP3d_R40,
     mAPaos_R40) = do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
                           compute_aos, PR_detail_dict=PR_detail_dict)

    ret_dict = {}
    for j, curcls in enumerate(current_classes):
        for i in range(min_overlaps.shape[0]):
            name = CLASS_TO_NAME[curcls]
            result += print_str(
                f'{name} AP@{min_overlaps[i, 0, j]:.2f}, '
                f'{min_overlaps[i, 1, j]:.2f}, {min_overlaps[i, 2, j]:.2f}:')
            result += print_str(
                f'bbox AP:{mAPbbox[j, 0, i]:.4f}, {mAPbbox[j, 1, i]:.4f}, '
                f'{mAPbbox[j, 2, i]:.4f}')
            result += print_str(
                f'bev  AP:{mAPbev[j, 0, i]:.4f}, {mAPbev[j, 1, i]:.4f}, '
                f'{mAPbev[j, 2, i]:.4f}')
            result += print_str(
                f'3d   AP:{mAP3d[j, 0, i]:.4f}, {mAP3d[j, 1, i]:.4f}, '
                f'{mAP3d[j, 2, i]:.4f}')
            result += print_str(
                f'bbox AP_R40:{mAPbbox_R40[j, 0, i]:.4f}, '
                f'{mAPbbox_R40[j, 1, i]:.4f}, {mAPbbox_R40[j, 2, i]:.4f}')
            result += print_str(
                f'bev  AP_R40:{mAPbev_R40[j, 0, i]:.4f}, '
                f'{mAPbev_R40[j, 1, i]:.4f}, {mAPbev_R40[j, 2, i]:.4f}')
            result += print_str(
                f'3d   AP_R40:{mAP3d_R40[j, 0, i]:.4f}, '
                f'{mAP3d_R40[j, 1, i]:.4f}, {mAP3d_R40[j, 2, i]:.4f}')
            if compute_aos:
                result += print_str(
                    f'aos  AP:{mAPaos[j, 0, i]:.2f}, {mAPaos[j, 1, i]:.2f}, '
                    f'{mAPaos[j, 2, i]:.2f}')
                if i == 0:
                    ret_dict[f'{name}_aos/easy_R40'] = mAPaos_R40[j, 0, 0]
                    ret_dict[f'{name}_aos/moderate_R40'] = mAPaos_R40[j, 1, 0]
                    ret_dict[f'{name}_aos/hard_R40'] = mAPaos_R40[j, 2, 0]
            if i == 0:
                ret_dict[f'{name}_3d/easy_R40'] = mAP3d_R40[j, 0, 0]
                ret_dict[f'{name}_3d/moderate_R40'] = mAP3d_R40[j, 1, 0]
                ret_dict[f'{name}_3d/hard_R40'] = mAP3d_R40[j, 2, 0]
                ret_dict[f'{name}_bev/easy_R40'] = mAPbev_R40[j, 0, 0]
                ret_dict[f'{name}_bev/moderate_R40'] = mAPbev_R40[j, 1, 0]
                ret_dict[f'{name}_bev/hard_R40'] = mAPbev_R40[j, 2, 0]
                ret_dict[f'{name}_image/easy_R40'] = mAPbbox_R40[j, 0, 0]
                ret_dict[f'{name}_image/moderate_R40'] = mAPbbox_R40[j, 1, 0]
                ret_dict[f'{name}_image/hard_R40'] = mAPbbox_R40[j, 2, 0]
                ret_dict[f'{name}_3d/easy'] = mAP3d[j, 0, 0]
                ret_dict[f'{name}_3d/moderate'] = mAP3d[j, 1, 0]
                ret_dict[f'{name}_3d/hard'] = mAP3d[j, 2, 0]

    return result, ret_dict


# COCO-style eval: AP averaged over a per-class range of IoU thresholds
# (reference eval.py:621-637 do_coco_style_eval, :723-811
# get_coco_eval_result).
CLASS_TO_COCO_RANGE = {
    0: [0.5, 0.95, 10],   # Car
    1: [0.25, 0.7, 10],   # Pedestrian
    2: [0.25, 0.7, 10],   # Cyclist
    3: [0.5, 0.95, 10],   # Van
    4: [0.25, 0.7, 10],   # Person_sitting
}


def do_coco_style_eval(gt_annos, dt_annos, current_classes, overlap_ranges,
                       compute_aos):
    """overlap_ranges: (3, metric, class) linspace args (start, stop, num).

    Evaluates at the 10 linspaced thresholds per (metric, class) and means
    the 11-point APs over the threshold axis (eval.py:621-637).
    """
    min_overlaps = np.zeros([10, *overlap_ranges.shape[1:]])
    for i in range(overlap_ranges.shape[1]):
        for j in range(overlap_ranges.shape[2]):
            start, stop, num = overlap_ranges[:, i, j]
            min_overlaps[:, i, j] = np.linspace(start, stop, int(num))
    (mAP_bbox, mAP_bev, mAP_3d, mAP_aos, _, _, _, _) = do_eval(
        gt_annos, dt_annos, current_classes, min_overlaps, compute_aos)
    # shape (num_class, num_difficulty, num_minoverlap) -> mean over overlaps
    mAP_bbox = mAP_bbox.mean(-1)
    mAP_bev = mAP_bev.mean(-1)
    mAP_3d = mAP_3d.mean(-1)
    if mAP_aos is not None:
        mAP_aos = mAP_aos.mean(-1)
    return mAP_bbox, mAP_bev, mAP_3d, mAP_aos


def get_coco_eval_result(gt_annos, dt_annos, current_classes):
    """(eval.py:723-811)."""
    name_to_class = {v: n for n, v in CLASS_TO_NAME.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [name_to_class[c] if isinstance(c, str) else int(c)
                       for c in current_classes]
    overlap_ranges = np.zeros([3, 3, len(current_classes)])
    for i, curcls in enumerate(current_classes):
        overlap_ranges[:, :, i] = np.array(
            CLASS_TO_COCO_RANGE[curcls])[:, np.newaxis]
    compute_aos = False
    for anno in dt_annos:
        if anno['alpha'].shape[0] != 0:
            if anno['alpha'][0] != -10:
                compute_aos = True
            break
    mAPbbox, mAPbev, mAP3d, mAPaos = do_coco_style_eval(
        gt_annos, dt_annos, current_classes, overlap_ranges, compute_aos)
    result = ''
    for j, curcls in enumerate(current_classes):
        name = CLASS_TO_NAME[curcls]
        o_range = np.array(CLASS_TO_COCO_RANGE[curcls])[[0, 2, 1]]
        o_range[1] = (o_range[2] - o_range[0]) / (o_range[1] - 1)
        result += print_str(
            f'{name} coco AP@{o_range[0]:.2f}:{o_range[1]:.2f}:'
            f'{o_range[2]:.2f}:')
        result += print_str(
            f'bbox AP:{mAPbbox[j, 0]:.2f}, {mAPbbox[j, 1]:.2f}, '
            f'{mAPbbox[j, 2]:.2f}')
        result += print_str(
            f'bev  AP:{mAPbev[j, 0]:.2f}, {mAPbev[j, 1]:.2f}, '
            f'{mAPbev[j, 2]:.2f}')
        result += print_str(
            f'3d   AP:{mAP3d[j, 0]:.2f}, {mAP3d[j, 1]:.2f}, '
            f'{mAP3d[j, 2]:.2f}')
        if compute_aos:
            result += print_str(
                f'aos  AP:{mAPaos[j, 0]:.2f}, {mAPaos[j, 1]:.2f}, '
                f'{mAPaos[j, 2]:.2f}')
    return result
