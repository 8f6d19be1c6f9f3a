"""Output builders: GeoJSON features, ROI mapping, densities, SpatialData
(counterpart of ``classpose_tpu/pipeline/outputs.py``).

The feature schema is the QuPath extension's contract (Polygon/Point
FeatureCollections with classification name and colour and the
area/perimeter/centroidX/centroidY measurements). The densities are rows
of plain dicts written with the ``csv`` module in pandas' column order
and number formatting, and the SpatialData store is the zarr-lite one
(``io/zarrlite.py``), so no pandas, geopandas, anndata or spatialdata is
needed.
"""

from __future__ import annotations

import csv
import json
import uuid
from pathlib import Path

import numpy as np

from classpose_tpu_torch.geometry import Polygon, STRtree, make_valid
from classpose_tpu_torch.io.zarrlite import ZarrGroup
from classpose_tpu_torch.log import get_logger

logger = get_logger(__name__)

DENSITY_COLUMNS = ("region", "cell_class", "count", "density")


# ----------------------------------------------------------- feature schema

def to_geojson_polygon(curr_cell: dict) -> dict:
    """Cell dict → GeoJSON Polygon feature."""
    return {
        "type": "Feature",
        "id": curr_cell["id"],
        "geometry": {
            "type": "Polygon",
            "coordinates": [curr_cell["coords"]],
        },
        "properties": {
            "objectType": "annotation",
            "isLocked": False,
            "classification": {
                "name": curr_cell["label"],
                "color": curr_cell["color"],
            },
            "measurements": [
                {"name": "area", "value": curr_cell["area"]},
                {"name": "perimeter", "value": curr_cell["perimeter"]},
                {"name": "centroidX", "value": curr_cell["centroid"][0]},
                {"name": "centroidY", "value": curr_cell["centroid"][1]},
            ],
        },
    }


def get_cell_centroid(cell: dict) -> tuple[float, float]:
    ms = {m["name"]: m["value"]
          for m in cell["properties"]["measurements"]}
    return ms["centroidX"], ms["centroidY"]


def polygons_to_centroids(cells: list[dict]) -> list[dict]:
    """Polygon features → Point features at their centroids."""
    output = []
    for cell in cells:
        cx, cy = get_cell_centroid(cell)
        output.append({
            "type": "Feature",
            "id": str(uuid.uuid4()),
            "geometry": {"type": "Point", "coordinates": [cx, cy]},
            "properties": {
                "objectType": "annotation",
                "isLocked": False,
                "classification": cell["properties"]["classification"],
                "measurements": cell["properties"]["measurements"],
            },
        })
    return output


def apply_bounds_offset_to_feature(feature: dict, bounds_x: float,
                                   bounds_y: float) -> dict:
    """Shift a feature into QuPath's bounds-relative coordinates."""
    if not feature or "geometry" not in feature:
        return feature
    geometry = feature["geometry"]
    if "coordinates" not in geometry:
        return feature
    if geometry["type"] == "Point":
        x, y = geometry["coordinates"]
        geometry["coordinates"] = [x - bounds_x, y - bounds_y]
    else:
        geometry["coordinates"] = [
            [[p[0] - bounds_x, p[1] - bounds_y] for p in ring]
            for ring in geometry["coordinates"]
        ]
    for m in feature.get("properties", {}).get("measurements", []):
        if m["name"] == "centroidX":
            m["value"] -= bounds_x
        elif m["name"] == "centroidY":
            m["value"] -= bounds_y
    return feature


def write_feature_collection(features: list[dict], path: str | Path) -> None:
    """Write a compact FeatureCollection, serializing the features in
    2000-feature ``json.dumps`` batches (memory bounded per batch)."""
    B = 2000
    with open(path, "w") as f:
        f.write('{"type": "FeatureCollection", "features": [')
        for i, s in enumerate(range(0, len(features), B)):
            chunk = json.dumps(features[s:s + B], separators=(",", ":"))
            if i:
                f.write(",")
            f.write(chunk[1:-1])
        f.write("]}")


# ------------------------------------------------------------- ROI handling

def load_roi_polygons(roi_geojson_path: str, group_by_class: bool = False):
    """GeoJSON FeatureCollection → STRtree (+ per-class polygon dict).
    LineStrings are closed into polygons, invalid rings repaired,
    MultiPolygons flattened, classes read from
    properties.classification.name."""
    with open(roi_geojson_path) as f:
        data = json.load(f)
    if isinstance(data, list):
        data = {"features": data}
    if "features" not in data and "geometry" in data:
        data = {"features": [data]}

    polys: list[Polygon] = []
    class_dict: dict[str, list[Polygon]] = {}
    for feat in data.get("features", []):
        geom = feat.get("geometry")
        if not geom:
            continue
        class_name = (feat.get("properties", {}).get("classification", {})
                      .get("name", "unknown")) if group_by_class else None
        for ring_poly in _geometry_to_polygons(geom):
            polys.append(ring_poly)
            if group_by_class:
                class_dict.setdefault(class_name, []).append(ring_poly)

    if group_by_class:
        logger.info("Loaded ROI polygons per class: %s (total: %d)",
                    {k: len(v) for k, v in class_dict.items()}, len(polys))
    tree = STRtree(polys) if polys else None
    return (tree, class_dict) if group_by_class else tree


def _geometry_to_polygons(geom: dict) -> list[Polygon]:
    gtype = geom.get("type")
    coords = geom.get("coordinates")
    out = []
    if gtype == "Polygon":
        out.append(Polygon(coords[0], holes=coords[1:]))
    elif gtype == "MultiPolygon":
        for rings in coords:
            out.append(Polygon(rings[0], holes=rings[1:]))
    elif gtype == "LineString":
        out.append(Polygon(list(coords) + [list(coords[0])]))
    validated = []
    for p in out:
        if p.is_valid:
            validated.append(p)
        else:
            validated.extend(Polygon(r) for r in make_valid(p.exterior))
    return validated


def filter_cells_by_tree(cells: list[dict], tree: STRtree,
                         keep_inside: bool = True) -> list[dict]:
    """Centroid-within filter: keep the cells inside (ROI, tissue) or
    outside (artefacts) the tree's polygons."""
    if tree is None or not cells:
        return cells
    pts = np.array([get_cell_centroid(c) for c in cells])
    inside = tree.contains_points(pts)
    keep = inside if keep_inside else ~inside
    out = [c for c, k in zip(cells, keep) if k]
    logger.info("Filtered cells: kept %d / %d", len(out), len(cells))
    return out


def map_cells_to_roi_classes(cells: list[dict],
                             roi_class_dict: dict[str, list[Polygon]],
                             priority_list: list[str] | None = None
                             ) -> dict[str, list[dict]]:
    """Assign each cell to the first matching ROI class by centroid
    containment, in priority order."""
    if priority_list:
        invalid = [c for c in priority_list if c not in roi_class_dict]
        if invalid:
            logger.warning(
                f"Priority list contains classes not found in ROI: {invalid}")
        ordered = [c for c in priority_list if c in roi_class_dict] + [
            c for c in roi_class_dict if c not in priority_list]
    else:
        ordered = list(roi_class_dict.keys())

    trees = {name: STRtree(polys)
             for name, polys in roi_class_dict.items() if polys}
    result: dict[str, list[dict]] = {name: [] for name in roi_class_dict}
    if not cells:
        return result
    pts = np.array([get_cell_centroid(c) for c in cells])
    assigned = np.zeros(len(cells), bool)
    for name in ordered:
        if name not in trees:
            continue
        if assigned.all():
            break
        idx = np.nonzero(~assigned)[0]
        hit = idx[trees[name].contains_points(pts[idx])]
        result[name].extend(cells[i] for i in hit)
        assigned[hit] = True
    for name, lst in result.items():
        logger.info(f"ROI class '{name}': {len(lst)} cells")
    return result


# ---------------------------------------------------------------- densities

def calculate_cellular_densities(cells, tissue_area_pixels,
                                 artefact_area_pixels, mpp_x: float,
                                 mpp_y: float, labels: list[str]
                                 ) -> list[dict]:
    """Cells/mm² per class, global or per ROI class (``cells`` a dict of
    region → cells), artefact-corrected. Returns rows with the keys of
    :data:`DENSITY_COLUMNS`."""
    mpp_product = mpp_x * mpp_y

    def _rows(region, cell_list, area_px):
        area_mm2 = area_px * mpp_product / 1e6
        counts = {label: 0 for label in labels}
        for cell in cell_list:
            name = cell["properties"]["classification"]["name"]
            if name in counts:
                counts[name] += 1
        return [{"region": region, "cell_class": label,
                 "count": counts[label],
                 "density": counts[label] / area_mm2 if area_mm2 > 0 else 0}
                for label in labels]

    if isinstance(cells, dict):
        rows = []
        for region, roi_cells in cells.items():
            rows += _rows(region, roi_cells,
                          tissue_area_pixels.get(region, 0)
                          - artefact_area_pixels.get(region, 0))
        return rows
    return _rows("tissue", cells, tissue_area_pixels - artefact_area_pixels)


def write_densities_csv(rows: list[dict], path: str | Path) -> None:
    """The densities as pandas' ``to_csv(index=False)`` writes them: a
    column holding any float is written as floats (``0`` → ``0.0``)."""
    float_cols = {c for c in DENSITY_COLUMNS
                  if any(isinstance(r[c], float) for r in rows)}

    def fmt(col, v):
        if col in float_cols:
            return repr(float(v))
        return v

    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(DENSITY_COLUMNS)
        for r in rows:
            w.writerow([fmt(c, r[c]) for c in DENSITY_COLUMNS])


# --------------------------------------------------------------- spatialdata

def create_spatialdata_output(output_path: str | Path, cells: list[dict],
                              tissue_features: list[dict] | None,
                              artefact_features: list[dict] | None,
                              roi_features: list[dict] | None,
                              densities: list[dict] | None,
                              metadata: dict) -> Path:
    """Write a SpatialData-style Zarr v2 store: shapes (cells, tissue,
    artefact and ROI as GeoJSON blobs), points (cell centroids and
    classes), the densities table in the AnnData v0.1 group schema, and
    the run metadata as attributes. Every array uses standard zarr v2
    encodings, so stock zarr/anndata open them."""
    output_path = Path(output_path)
    root = ZarrGroup(output_path, attrs={
        "metadata": metadata, "spatialdata_attrs": {"version": "0.1-lite"}})
    shapes = root.group("shapes")
    for name, feats in [
        ("cell_contours", cells),
        ("tissue_contours", tissue_features),
        ("artefact_contours", artefact_features),
        ("roi_contours", roi_features),
    ]:
        if feats:
            blob = json.dumps({"type": "FeatureCollection",
                               "features": feats})
            shapes.group(name).string_array("geojson", [blob],
                                            attrs={"encoding": "geojson"})
    if cells:
        pts = np.array([get_cell_centroid(c) for c in cells])
        points = root.group("points").group("cell_centroids")
        points.array("x", pts[:, 0])
        points.array("y", pts[:, 1])
        points.string_array(
            "classification",
            [c["properties"]["classification"]["name"] for c in cells])
    if densities:
        _write_anndata_lite(root.group("tables"), "cellular_densities",
                            densities)
    logger.info("Wrote SpatialData store to %s", output_path)
    return output_path


def _write_anndata_lite(tables_group, name: str,
                        densities: list[dict]) -> None:
    """The densities table in the AnnData v0.1 zarr schema: X = [count,
    density], obs = region/cell_class."""
    ad = tables_group.group(
        name, attrs={"encoding-type": "anndata", "encoding-version": "0.1.0"})
    X = np.array([[r["count"], r["density"]] for r in densities],
                 np.float64)
    ad.array("X", X, attrs={"encoding-type": "array",
                            "encoding-version": "0.2.0"})
    n = len(densities)
    str_attrs = {"encoding-type": "string-array",
                 "encoding-version": "0.2.0"}
    obs = ad.group("obs", attrs={
        "encoding-type": "dataframe", "encoding-version": "0.2.0",
        "column-order": ["region", "cell_class"], "_index": "_index"})
    obs.string_array("_index", [str(i) for i in range(n)], str_attrs)
    obs.string_array("region", [r["region"] for r in densities], str_attrs)
    obs.string_array("cell_class", [r["cell_class"] for r in densities],
                     str_attrs)
    var = ad.group("var", attrs={
        "encoding-type": "dataframe", "encoding-version": "0.2.0",
        "column-order": [], "_index": "_index"})
    var.string_array("_index", ["count", "density"], str_attrs)
    dict_attrs = {"encoding-type": "dict", "encoding-version": "0.1.0"}
    for sub in ("obsm", "varm", "obsp", "varp", "layers", "uns"):
        ad.group(sub, attrs=dict_attrs)
