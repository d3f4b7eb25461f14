"""Render configuration.

Counterpart of reference `render_settings` (`render.h:21-50`).  The
reference mutates a struct in `main.cu` and derives values via `calc_all`; here
everything is a frozen dataclass whose derived values are properties, and the
fields that shape compiled programs (resolution, spp, depth, batch size) are
*static* — they select the XLA program, they are not traced.

The reference's `no_fb` frame-buffer ensemble (`render.h:37,152`) survives as
`num_chunks`: the sample dimension is split into independently rendered,
independently checkpointable chunks of `spp_per_chunk` samples.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    image_width: int = 1200                  # reference `render.h:22`
    aspect_ratio: float = 16.0 / 9.0         # reference `render.h:24`
    spp_per_chunk: int = 100                 # reference samples_per_pixel_per_fb `render.h:26`
    num_chunks: int = 10                     # reference no_fb `render.h:37`
    max_depth: int = 50                      # reference `render.h:27`
    ray_batch: int = 65536                   # wavefront batch size (rays per wave);
    #                                          replaces the 8x8 CUDA block shape `render.h:129-130`
    t_min: float = 0.001                     # reference `render.h:62`
    seed: int = 1984                         # reference seed `render.h:91`
    rr_start: int = 0                        # russian roulette from this bounce
    #                                          (0 = off).  The reference runs a
    #                                          fixed 50-bounce loop per thread
    #                                          (`render.h:27,60`); a wave pays
    #                                          for its deepest live lane, so RR
    #                                          cuts the dead-lane tail at
    #                                          depth-50 defaults.  Unbiased:
    #                                          survivors are reweighted by 1/p.

    @property
    def image_height(self) -> int:
        # reference `calc_height` (`render.h:30-33`)
        return int(self.image_width / self.aspect_ratio)

    @property
    def num_pixels(self) -> int:
        return self.image_width * self.image_height

    @property
    def rays_per_pixel(self) -> int:
        # reference `calc_rays` (`render.h:35-38`)
        return self.spp_per_chunk * self.num_chunks

    def with_(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)
