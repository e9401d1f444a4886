"""Weight and record interop: the Caffe `.caffemodel` reader and writer,
the TFRecord codec of the reference's action records (numpy only), and
the TF1 checkpoint import (needs tensorflow, imported when called)."""

from .caffemodel import (
    c3d_params_from_caffemodel,
    parse_caffemodel,
    write_caffemodel,
)
from .tf_import import (
    grcn_params_from_tf,
    load_tf_variables,
    shallownet_params_from_tf,
    tf_deconv_kernel_to_jax,
)
from .tfrecord import (
    read_reference_tfrecord,
    write_reference_tfrecord,
)

__all__ = [
    "parse_caffemodel",
    "write_caffemodel",
    "c3d_params_from_caffemodel",
    "load_tf_variables",
    "shallownet_params_from_tf",
    "grcn_params_from_tf",
    "tf_deconv_kernel_to_jax",
    "read_reference_tfrecord",
    "write_reference_tfrecord",
]
