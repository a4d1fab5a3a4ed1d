"""The container-runtime hook that hands a pod its allocated GPUs."""
