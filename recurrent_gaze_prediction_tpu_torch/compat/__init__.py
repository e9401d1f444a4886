"""Weight interop: the Caffe `.caffemodel` reader and writer."""
