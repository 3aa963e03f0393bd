"""Interactive guide/feature plots as self-contained Vega-Lite HTML.

The reference's Altair charts (its core.py:988-1062), written as the
equivalent Vega-Lite v5 spec: per accession, a feature-density area and a
guide-density area (linked by an interval brush) over a per-locus bar
colored by PAM.  Vega estimates the densities in the browser, as Altair's
``transform_density`` does, so no plotting library is needed.
"""
from __future__ import annotations

import json
import os

import pandas as pd

_HTML_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
  <meta charset="utf-8"/>
  <script src="https://cdn.jsdelivr.net/npm/vega@5"></script>
  <script src="https://cdn.jsdelivr.net/npm/vega-lite@5"></script>
  <script src="https://cdn.jsdelivr.net/npm/vega-embed@6"></script>
</head>
<body>
  <div id="vis"></div>
  <script type="text/javascript">
    const spec = {spec};
    vegaEmbed('#vis', spec).catch(console.error);
  </script>
</body>
</html>
"""


def _single_spec(df: pd.DataFrame) -> dict:
    """Vega-Lite spec of the reference's per-accession chart."""
    source = df.where(pd.notna(df), None)
    records = json.loads(source.to_json(orient="records"))
    max_end = int(df["Feature end"].max())
    bin_num = int(round(max_end / 200, 0)) or 1
    display_info = df.columns.tolist()

    density_feature = {
        "transform": [{
            "density": "Feature start",
            "as": ["Feature start", "Feature Density"],
            "extent": [1, max_end],
            "bandwidth": bin_num,
        }],
        "mark": {"type": "area", "color": "black", "opacity": 0.6},
        "encoding": {
            "x": {"field": "Feature start", "type": "quantitative",
                  "axis": {"title": "Genome Coordinates (bp)", "tickCount": 5}},
            "y": {"field": "Feature Density", "type": "quantitative"},
        },
        "height": 50, "width": 500,
    }
    density_guide = {
        "transform": [{
            "density": "Guide start",
            "as": ["Guide start", "Guide Density"],
            "extent": [1, max_end],
            "bandwidth": bin_num,
        }],
        "mark": {"type": "area", "color": "pink", "opacity": 0.6},
        "encoding": {
            "x": {"field": "Guide start", "type": "quantitative",
                  "axis": {"title": "Genome Coordinates (bp)", "tickCount": 5}},
            "y": {"field": "Guide Density", "type": "quantitative"},
        },
        "params": [{"name": "brush",
                    "select": {"type": "interval", "encodings": ["x"]}}],
        "height": 50, "width": 500,
    }
    locus_bar = {
        "transform": [{"filter": {"param": "brush"}}],
        "mark": {"type": "bar", "cornerRadiusTopLeft": 3,
                 "cornerRadiusTopRight": 3},
        "encoding": {
            "x": {"aggregate": "count", "field": "locus_tag",
                  "type": "quantitative"},
            "y": {"field": "locus_tag", "type": "nominal",
                  "axis": {"title": "Locus"}},
            "color": {"field": "PAM", "type": "nominal"},
            "tooltip": [{"field": c} for c in display_info],
        },
        "height": 500, "width": 500,
    }
    return {
        "$schema": "https://vega.github.io/schema/vega-lite/v5.json",
        "data": {"values": records},
        "vconcat": [density_feature, density_guide, locus_bar],
    }


class GuideMakerPlot:
    """Write one interactive HTML chart per accession (core.py:988-1062)."""

    def __init__(self, prettydf: pd.DataFrame, outdir: str) -> None:
        self.prettydf = prettydf
        self.accession = list(set(self.prettydf["Accession"]))
        os.makedirs(outdir, exist_ok=True)
        for accession in self.accession:
            df = self.prettydf[self.prettydf["Accession"] == accession]
            spec = _single_spec(df)
            path = os.path.join(outdir, f"{accession}.html")
            with open(path, "w") as f:
                f.write(_HTML_TEMPLATE.replace("{spec}", json.dumps(spec)))
