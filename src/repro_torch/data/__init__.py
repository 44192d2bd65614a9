from repro_torch.data.memmap import (  # noqa: F401
    DataState,
    IndexedPackedDataset,
    TokenCache,
    load_meta,
    write_token_cache,
)
from repro_torch.data.pack_index import (  # noqa: F401
    PackIndex,
    build_pack_index,
    gather_rows,
)
from repro_torch.data.pipeline import (  # noqa: F401
    device_prefetch,
    device_stream,
    host_slice,
    pack_sequences,
    prefetch,
    shard_batch,
)
from repro_torch.data.synthetic import (  # noqa: F401
    CTRModel,
    MarkovLM,
    classification_batches,
    classification_data,
    ctr_batches,
    linreg_data,
    lm_batches,
    markov_documents,
    packed_lm_batches,
)
