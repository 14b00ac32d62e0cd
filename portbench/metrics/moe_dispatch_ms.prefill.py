"""MoE layer: device milliseconds a step of the dispatch around the
experts' products, matched by the names of its kernels in the card's
trace (torch 2.11), which each of the step's 16 layers launches:

* the router's softmax over the experts (``softmax_warp_forward``) and
  the sort that picks its top k (``radixSortKVInPlace``), with the gather
  of the chosen weights (``_scatter_gather_elementwise_kernel``);
* the sort of the (token, choice) pairs by expert (cub's
  ``DeviceRadixSort*`` kernels) and the search for the experts' offsets
  (``searchsorted_cuda_kernel``);
* the gather of the rows into expert order (``vectorized_gather_kernel``,
  which also serves the step's one embedding lookup, under 1% of it);
* the weighted add back in token order: the rows times their weights in
  float32 (``elementwise_kernel`` of a float multiply with a cast,
  ``gpu_kernel_impl<BinaryFunctor<float, float, float, MulFunctor>>``,
  which nothing else in the step launches) and the float32 scatter-add
  (``indexFuncLargeIndex``).

The small passes between them (the division of the pairs' order by k,
the zeroed float32 sum, its cast back) share their kernels' names with
the rest of the step and are not counted."""

KERNELS = (r"softmax_warp_forward|SoftMaxForward|radixSortKV|"
           r"_scatter_gather_elementwise|DeviceRadixSort|searchsorted|"
           r"vectorized_gather_kernel|indexFuncLargeIndex|"
           r"gpu_kernel_impl<at::native::BinaryFunctor<float, float, float, "
           r"at::native::binary_internal::MulFunctor<float>")


def read(r):
    if not r.traced or "n_experts" not in r.shape or not r.window.units:
        return None
    t = r.capture.seconds(KERNELS)
    if not t:
        return None
    return 1e3 * t / r.window.units
