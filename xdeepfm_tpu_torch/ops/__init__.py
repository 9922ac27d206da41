from .cin import (
    cin_layer_contract,
    cin_rows_contract,
    get_cin_backend,
    get_cin_precision,
    set_cin_backend,
    set_cin_precision,
)
