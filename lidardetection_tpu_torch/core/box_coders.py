"""Anchor residual box coder (lidardetection_tpu/core/box_coders.py:14)."""

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


def build_box_coder(name, **kwargs):
    if name != 'ResidualCoder':
        raise NotImplementedError(
            f'box coder {name} is not ported yet: see ROADMAP.md queue 1, '
            '"PV-RCNN" (point coders) and "PointRCNN"')
    fields = {f.name for f in dataclasses.fields(ResidualCoder)}
    return ResidualCoder(**{k: v for k, v in kwargs.items() if k in fields})
