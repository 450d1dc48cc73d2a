"""The served language model: parameter descriptors, GQA attention, the
dense MLP and the dense decoder's prefill and KV-cache decode (the JAX
package's `models/`, its dense serving path)."""
