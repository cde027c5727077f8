from qpnet_tpu_torch.data.h5io import read_hdf5, shape_hdf5  # noqa: F401
from qpnet_tpu_torch.data.lists import (  # noqa: F401
    check_filenames, find_files, read_txt,
)
from qpnet_tpu_torch.data.stats import Scaler, load_scaler  # noqa: F401
