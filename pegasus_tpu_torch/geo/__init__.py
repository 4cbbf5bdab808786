from pegasus_tpu_torch.geo.cells import cell_id, covering_cells, haversine_m
from pegasus_tpu_torch.geo.geo_client import (
    GeoClient,
    GeoSearchResult,
    LatLngCodec,
)

__all__ = ["GeoClient", "GeoSearchResult", "LatLngCodec", "cell_id",
           "covering_cells", "haversine_m"]
