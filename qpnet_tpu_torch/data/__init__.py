from qpnet_tpu_torch.data.h5io import (  # noqa: F401
    check_hdf5, read_hdf5, shape_hdf5, write_hdf5,
)
from qpnet_tpu_torch.data.lists import (  # noqa: F401
    check_filenames, find_files, read_txt, write_txt,
)
from qpnet_tpu_torch.data.stats import (  # noqa: F401
    Scaler, calc_stats, load_scaler,
)
