"""Images a device call of the HTTP server's batcher: the deltas of
``BatchingDetector.stats``' ``batched_images`` over ``device_calls`` across
the window."""


def read(run):
    lay = run.layer
    calls = lay.get("device_calls")
    if lay.get("kind") != "http" or not calls:
        return None
    return lay["batched_images"] / calls
