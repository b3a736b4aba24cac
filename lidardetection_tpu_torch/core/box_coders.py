"""Box coders (lidardetection_tpu/core/box_coders.py): the anchor residual
coder (:14), the two legacy decoders (:77-130) and PointRCNN's point
residual coder (:131-186)."""

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ResidualCoder:
    """7(+1 with sincos)-dim anchor residual coder."""

    code_size: int = 7
    encode_angle_by_sincos: bool = False

    @property
    def full_code_size(self):
        return self.code_size + (1 if self.encode_angle_by_sincos else 0)

    def encode(self, boxes, anchors):
        """boxes, anchors: (..., 7 + C) -> (..., code_size).

        Sizes are clamped to >= 1e-5 on local copies, never in place."""
        anchors = torch.cat([anchors[..., :3], anchors[..., 3:6].clamp(min=1e-5),
                             anchors[..., 6:]], dim=-1)
        boxes = torch.cat([boxes[..., :3], boxes[..., 3:6].clamp(min=1e-5),
                           boxes[..., 6:]], dim=-1)
        xa, ya, za, dxa, dya, dza, ra = anchors[..., :7].unbind(-1)
        xg, yg, zg, dxg, dyg, dzg, rg = boxes[..., :7].unbind(-1)

        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        xt = (xg - xa) / diagonal
        yt = (yg - ya) / diagonal
        zt = (zg - za) / dza
        dxt = torch.log(dxg / dxa)
        dyt = torch.log(dyg / dya)
        dzt = torch.log(dzg / dza)
        if self.encode_angle_by_sincos:
            rts = [torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)]
        else:
            rts = [rg - ra]
        cts = [boxes[..., 7 + i] - anchors[..., 7 + i]
               for i in range(boxes.shape[-1] - 7)]
        return torch.stack([xt, yt, zt, dxt, dyt, dzt, *rts, *cts], dim=-1)

    def decode(self, box_encodings, anchors):
        """box_encodings (..., code_size), anchors (..., 7 + C) -> (..., 7 + C)."""
        xa, ya, za, dxa, dya, dza, ra = anchors[..., :7].unbind(-1)
        if not self.encode_angle_by_sincos:
            xt, yt, zt, dxt, dyt, dzt, rt = box_encodings[..., :7].unbind(-1)
            extra_start = 7
        else:
            xt, yt, zt, dxt, dyt, dzt, cost, sint = \
                box_encodings[..., :8].unbind(-1)
            extra_start = 8

        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        xg = xt * diagonal + xa
        yg = yt * diagonal + ya
        zg = zt * dza + za
        dxg = torch.exp(dxt) * dxa
        dyg = torch.exp(dyt) * dya
        dzg = torch.exp(dzt) * dza
        if self.encode_angle_by_sincos:
            rg = torch.atan2(sint + torch.sin(ra), cost + torch.cos(ra))
        else:
            rg = rt + ra
        # zip-truncate the extra columns, as the reference does
        n_extra = min(anchors.shape[-1] - 7,
                      box_encodings.shape[-1] - extra_start)
        extras = [box_encodings[..., extra_start + i] + anchors[..., 7 + i]
                  for i in range(n_extra)]
        return torch.stack([xg, yg, zg, dxg, dyg, dzg, rg, *extras], dim=-1)


def _previous_decode(box_encodings, anchors, roi):
    """The legacy decode: size residuals in (w, l, h) order, so dx takes
    the second and dy the first; the heading ``ra - rt`` for the RoI
    decoder, ``rt + ra`` otherwise; every extra column added to its
    anchor's."""
    xa, ya, za, dxa, dya, dza, ra = anchors[..., :7].unbind(-1)
    xt, yt, zt, wt, lt, ht, rt = box_encodings[..., :7].unbind(-1)
    diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
    xg = xt * diagonal + xa
    yg = yt * diagonal + ya
    zg = zt * dza + za
    dxg = torch.exp(lt) * dxa
    dyg = torch.exp(wt) * dya
    dzg = torch.exp(ht) * dza
    rg = ra - rt if roi else rt + ra
    extras = [box_encodings[..., 7 + i] + anchors[..., 7 + i]
              for i in range(anchors.shape[-1] - 7)]
    return torch.stack([xg, yg, zg, dxg, dyg, dzg, rg, *extras], dim=-1)


@dataclasses.dataclass(frozen=True)
class PreviousResidualDecoder:
    """Legacy anchor decoder (decode only): `_previous_decode`."""

    code_size: int = 7

    @property
    def full_code_size(self):
        return self.code_size

    @staticmethod
    def decode(box_encodings, anchors):
        return _previous_decode(box_encodings, anchors, roi=False)


@dataclasses.dataclass(frozen=True)
class PreviousResidualRoIDecoder:
    """Legacy RoI decoder (decode only): `_previous_decode` with the
    heading ``ra - rt``."""

    code_size: int = 7

    @property
    def full_code_size(self):
        return self.code_size

    @staticmethod
    def decode(box_encodings, anchors):
        return _previous_decode(box_encodings, anchors, roi=True)


@dataclasses.dataclass(frozen=True)
class PointResidualCoder:
    """8-dim box residuals of a point: the offsets over the class's mean
    size (diagonal for x and y, height for z), the log size ratios, then
    cos and sin of the heading. Classes are 1-indexed into ``mean_size``
    (clipped into it); without ``use_mean_size`` the offsets are plain and
    the sizes are logs."""

    code_size: int = 8
    use_mean_size: bool = True
    mean_size: tuple = ()  # ((dx, dy, dz) per class)

    @property
    def full_code_size(self):
        return self.code_size

    def _sizes_for(self, classes):
        mean = torch.tensor(self.mean_size, dtype=torch.float32,
                            device=classes.device)
        return mean[(classes.long() - 1).clamp(0, mean.shape[0] - 1)]

    def encode(self, gt_boxes, points, gt_classes=None):
        """gt_boxes (..., 7 + C), points (..., 3), gt_classes (...,) in [1,
        num_class] -> (..., 8 + C)."""
        gt_boxes = torch.cat([gt_boxes[..., :3], gt_boxes[..., 3:6].clamp(min=1e-5),
                              gt_boxes[..., 6:]], dim=-1)
        xg, yg, zg, dxg, dyg, dzg, rg = gt_boxes[..., :7].unbind(-1)
        xa, ya, za = points[..., :3].unbind(-1)
        if self.use_mean_size:
            dxa, dya, dza = self._sizes_for(gt_classes).unbind(-1)
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            xt = (xg - xa) / diagonal
            yt = (yg - ya) / diagonal
            zt = (zg - za) / dza
            dxt = torch.log(dxg / dxa)
            dyt = torch.log(dyg / dya)
            dzt = torch.log(dzg / dza)
        else:
            xt, yt, zt = xg - xa, yg - ya, zg - za
            dxt, dyt, dzt = torch.log(dxg), torch.log(dyg), torch.log(dzg)
        extras = [gt_boxes[..., 7 + i] for i in range(gt_boxes.shape[-1] - 7)]
        return torch.stack([xt, yt, zt, dxt, dyt, dzt, torch.cos(rg),
                            torch.sin(rg), *extras], dim=-1)

    def decode(self, box_encodings, points, pred_classes=None):
        """box_encodings (..., 8 + C), points (..., 3), pred_classes (...,)
        -> boxes (..., 7 + C), the heading ``atan2(sin, cos)``."""
        xt, yt, zt, dxt, dyt, dzt, cost, sint = box_encodings[..., :8].unbind(-1)
        xa, ya, za = points[..., :3].unbind(-1)
        if self.use_mean_size:
            dxa, dya, dza = self._sizes_for(pred_classes).unbind(-1)
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            xg = xt * diagonal + xa
            yg = yt * diagonal + ya
            zg = zt * dza + za
            dxg = torch.exp(dxt) * dxa
            dyg = torch.exp(dyt) * dya
            dzg = torch.exp(dzt) * dza
        else:
            xg, yg, zg = xt + xa, yt + ya, zt + za
            dxg, dyg, dzg = torch.exp(dxt), torch.exp(dyt), torch.exp(dzt)
        rg = torch.atan2(sint, cost)
        extras = [box_encodings[..., 8 + i]
                  for i in range(box_encodings.shape[-1] - 8)]
        return torch.stack([xg, yg, zg, dxg, dyg, dzg, rg, *extras], dim=-1)


_CODERS = {'ResidualCoder': ResidualCoder,
           'PreviousResidualDecoder': PreviousResidualDecoder,
           'PreviousResidualRoIDecoder': PreviousResidualRoIDecoder,
           'PointResidualCoder': PointResidualCoder}


def build_box_coder(name, **kwargs):
    cls = _CODERS[name]
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in kwargs.items() if k in fields}
    if 'mean_size' in kwargs:
        kwargs['mean_size'] = tuple(tuple(float(v) for v in s)
                                    for s in kwargs['mean_size'])
    return cls(**kwargs)
