"""Expert stores of the port: the record blob (read by memory map, from RAM,
or by the native O_DIRECT reader and priority scheduler), a synthetic store,
the page-locked host tier, and the ingest of plain, GPTQ and block-fp8
checkpoints."""
