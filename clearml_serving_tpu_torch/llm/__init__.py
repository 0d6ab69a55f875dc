"""Engine, KV cache, sampling and the OpenAI front of the port."""
