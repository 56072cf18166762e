"""Each kernel's work from its launch shapes, one file a kernel (``k1.py``
... ``k7.py``): ``SYMBOL``, the name of its ``__global__`` function as a
device trace shows it, and ``n_bytes`` and ``flops``, the bytes it must move
(each input read once, each output written once) and its f32 operations
(a multiply-add is two), counting the work these inputs need."""
