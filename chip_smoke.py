#!/usr/bin/env python3
"""On-card smoke run of pinot_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed 2024] [--rows-per-segment 8388608]
                          [--segments 4] [--iters 3]

Phases, each printing one JSON line:
  device   the card, its compute capability and power limit
  build    nvcc builds csrc/*.cu for sm_90a; ptxas register/smem lines;
           g++ builds the native host library (csrc/host_native.cpp)
  parity   each CUDA kernel against its plain PyTorch version on the card,
           element-equal int64, at the main path's shapes and at the edges
           of the kernels' domain and geometry: a table split across the
           cluster, G = 32768, unaligned n, n below and at one tile, n = 0,
           and 2^25 + 5 rows of 127 on one group (the sum passes 2^31), also
           with one lone CTA and one lone cluster taking every row; kernel
           A with its family axis (one launch for S segments) at S = 1, 16
           members of a ragged n and ragged live rows, a member with no
           live row, and one cluster whose range crosses every segment;
           and both kernels on the recorded inputs of every query that
           launches them; and the histogram bins of HISTOGRAM and of the
           adaptive percentile histogram on the card element-equal to the
           port's CPU run (on values at bin edges, where a width computed
           another way moves a row)
  data     an SSB-shaped table generated from --seed, built with the
           port's builder (every segment in the spawn process pool of
           index_data) into --segments segments, and the same rows again
           into 16 segments (bench.py's 16-segment q4, q3m); the same rows
           with a tags-like INT multi-value column (1 to 4 values a row of
           1000) in --segments segments (table `mvt`); bench.py's taxi table
           (seed 7) in --segments segments, its planes warmed; the same rows
           with two TIMESTAMP columns (table `ssbt`: lo_orderdate, a day of
           the row's d_year, dictionary-encoded; lo_commit_ts, up to 90
           days later in millis, raw); bench.py's `brands` dimension table
           (1000 rows), registered with QueryExecutor.add_dimension_table
  index_data
           the index tables, their segments built by the port's builder
           in parallel worker processes: `ssb_st`, the ssb rows with a
           star-tree (split order d_year, s_region, p_brand; COUNT, the
           three SUMs and MIN/MAX of lo_quantity); `events`, 4 x 2^19
           gen_ssb rows (seed 2030) with a JSON (`attrs`), a text (`msg`)
           and a map (`props`) index column; `vecs`, 4 x 2^16 rows with a
           384-wide FLOAT embedding and its vector index (IVF)
  queries  every query through QueryExecutor(device="cuda").execute_sql,
           each held against a numpy oracle, with its launches of each
           kernel, device dispatches and host fetches (every count set to 0
           just before the query and read just after):
             q1, q2, q9, q2 unfused, flagship   SET segmentBatch = false:
                 one dispatch per segment, kernel B for q2/q9 (as measured
                 before families existed)
             q2_family, flagship_family         the default: one batch
                 family, one dispatch, one fetch, one launch of kernel A
             q3, q3_sort                        sparse GROUP BY (presorted
                 keys + the device combine; the sort path + the host merge)
             q4, q3m, sparse_family             over the 16-segment table:
                 one family of 16 (q4, sparse_family), the device combine
                 (q3m, sparse_family)
             q4_solo, sparse_family_solo        their SET segmentBatch =
                 false twins (16 dispatches; kernel B on q4_solo)
             q5, q5_total                       bench.py Q5 over `taxi` (one
                 family of 4: DISTINCTCOUNT and the adaptive histogram of
                 PERCENTILETDIGEST, kernel A at one plane), and its
                 un-grouped form with HISTOGRAM
             aggmix                             every device kind of the
                 matrix-shaped aggregations in one family query on ssb
             q6, q6m, q6_sort                   bench.py Q6 (presorted
                 sparse DISTINCT, the host merge) on ssb and ssb16 (16
                 dispatches, no device combine), and its sort path with the
                 ids packed into the key
             sel_limit, sel_order               selections on ssb: one
                 family, one dispatch, one fetch of the 4 packed bitmaps
             sel_pruned, agg_all_pruned         segment pruning on the
                 sorted lo_orderkey: 3 of 4 segments pruned, 1 dispatch;
                 all 4 pruned, no dispatch, rows [[0, []]]
             mv_filter, mv_group, mv_aggs       on mvt: an any-value MV
                 filter; GROUP BY the MV column (kernel A over the
                 (doc x value slot) pairs); the *MV value aggregations (the
                 matrix-shaped MV functions are refused, as the JAX
                 package's device planner refuses them)
             q7                                 bench.py Q7 verbatim: LOOKUP
                 into `brands` as a filter (a LUT over p_brand's ids) and a
                 GROUP BY key (a derived dimension), kernel A at 7 x 40
             time_group, str_group              on ssbt: GROUP BY
                 DATETRUNC('MONTH', ...) and by toDateTime(..., 'yyyy-MM'),
                 LOWER(s_region) under a SUBSTR filter, all evaluated over
                 the dictionaries and gathered by id
             time_raw                           on ssbt: the int64
                 civil-date chain of MONTH(lo_commit_ts) over the raw
                 column in the filter, an int64 expression summed
             post_agg                           ROUNDDECIMAL over SUM / COUNT
                 in the reduce (the registry's scalar form); a GROUP BY on a
                 transform of a raw column and a two-column transform past
                 the 2^18 table are refused, as the JAX package's device
                 planner refuses them
             st_q2, st_q9, st_avg, st_bypass    on ssb_st: bench.py Q2
                 and Q9 answered from the star-tree's pre-aggregated rows
                 (one family of the 4 views, kernel A at 7001 groups),
                 COUNT and AVG sharing one count pair, and bench.py Q1,
                 which filters a column off the split order (no rewrite)
             ix_json, ix_text, ix_map, ix_vec   JSON_MATCH, TEXT_MATCH (a
                 phrase OR a prefix, AND a dictionary predicate), a
                 mapValue RANGE over the map index, VECTOR_SIMILARITY
                 top-100 a segment: each a host-evaluated mask plane in one
                 family dispatch (ix_vec's rows are the port's CPU run's)
           and, after phase `realtime`, a second line for its queries at
           their final state:
             rt_q1, rt_q2, rt_range             bench.py Q1 and Q2 and a
                 RANGE on d_year over `ssb_rt`: the family of 4, then the
                 consuming snapshot (2 dispatches, 1 fetch; kernel B on its
                 Q2 and RANGE, the RANGE a LUT over its insertion-ordered
                 dictionary)
             ups                                GROUP BY d_year over `ups`:
                 kernel A on the committed and on the consuming segment,
                 each with its upsert validity plane in the filter
  timeseries
           the timeseries engine (m3ql) over ssbt, in process through
           TimeSeriesEngine(qe) and through POST
           /timeseries/api/v1/query_range of a BrokerRestServer holding
           it: a weekly SUM of lo_revenue by s_region under lo_quantity <
           25 | moving_avg 4 | topk 3, a daily MAX by s_region, a 30-day
           COUNT | transform_null 0 over 1991-1999; each fetch one launch
           of kernel A over the family (G 1836, 12786, 88), each block
           equal to the numpy oracle's JSON; the fetch's p50 (ending in a
           synchronize), the pipe's, the REST p50; the fetch over the raw
           lo_commit_ts refused (TimeSeriesQueryError; 500 over REST)
  segment_formats
           `ssbz`: phase data's rows in 4 segments of 2^21, segment k the
           rows whose lo_orderkey is k modulo 4 (stamped modulo 4), built
           in the spawn pool with lo_revenue raw under LZ4,
           lo_extendedprice raw under SNAPPY, p_brand's ids under GZIP, a
           raw var-width lo_note, a CLP lo_log of templated lines and a
           bloom filter on s_region, and registered under a schema that
           adds s_nation and lo_tax (virtual default columns in every
           segment): per codec the ms and MB/s of decompressing the
           buffers on their first read, the ms of decoding one segment's
           whole lo_note and lo_log, then z_year (GROUP BY d_year over the
           LZ4 plane, kernel A over the family), z_q2_family and z_q2
           (bench.py Q2 over the GZIP p_brand: kernel A over the family,
           kernel B a segment), z_evolved (GROUP BY s_nation, SUM(lo_tax):
           kernel A), z_select (lo_note and lo_log of 10 rows beside a
           filter on the card), z_bloom (a region no row holds, inside
           every segment's min / max: 4 pruned) and z_partition (one
           lo_orderkey inside every segment's range: 3 pruned), each
           counted from 0, its rows held against a numpy oracle, its
           dispatches, launches and pruned / processed segments against
           what the data implies, every launch against the plain version;
           cold and warm p50s
  realtime consuming segments on the card (the same counts, set to 0 just
           before the phase and read after it): `ssb_rt`, the 4 ssb
           segments plus a consuming segment of the ssb schema fed a row at
           a time (gen_ssb rows from --seed + 3) through generations g0
           (2^19 - 2^13 rows), g1 (+2^14, crossing into the 2^20 bucket:
           every plane grows on the card) and g2 (+2^10), each query cold
           then warm: rows equal to the numpy oracle over every row the
           pinned snapshot holds, 2 dispatches and 1 fetch; per generation
           the delta bytes and uploads, the host-clock ms of reading the
           delta out of the consuming segment and of uploading it, the warm
           p50 and the plane bytes. g0's warm repeat must upload nothing,
           g1's tail must be below 1/8 of g0's bytes. Then `ups`, an upsert
           table (FULL, comparison column ts = arrival order, one row in
           64 older than every version) of the ssb columns plus a pk LONG
           drawn from 2^17 keys: one committed segment of 2^18 rows (built,
           then replayed with add_segment) and one consuming segment of
           2^18 rows (index + add_record), queried before and after 2^13
           more rows overwrite keys: rows equal to the oracle of the
           newest version of each key, and the overwrite must change them
  ingest   realtime tables fed from a stream through the port's
           RealtimeTableDataManager (stream SPI, transform pipeline,
           consuming segments, commit, checkpoints), each counted query's
           counts set to 0 just before it and its rows held against a numpy
           oracle over the rows read back from the topic: `ingest`, the ssb
           schema from a 2-partition topic keyed by lo_orderkey through the
           Kafka plugin (`streamType: kafka`, its client_factory over
           MemKafka, an in-process Kafka cluster with kafka-python's
           consumer surface), 288,000 rows a partition on average (--seed +
           6, published in batches of 64,000 while the consumers run; each
           segment seals at 256,000 rows), at its settle point 2 committed
           segments (kernel A over their family) and the consuming
           snapshots, rt_q1, rt_q2 and rt_range and their warm p50; the
           freshness of a 1,000-row trickle; force_commit and the cold
           queries after it; a restart from the checkpoints (offsets equal
           to the topic's, the segments loaded in commit order, nothing
           consumed again). Then two replicas on one partition (288,000
           rows, flush 256,000) through two leader-elected controllers'
           completion protocol, each replica with its own executor on the
           card: one DONE record and one name, the loser downloading the
           winner's build, rt_q2 on both (kernel B on the committed segment
           and on the snapshot); a leaderless window (both controllers
           killed: the consumers hold, never ERROR, and commit once one is
           back); a committer that dies before segment_commit_end, replaced
           after its 2 s lease. Then an upsert table (262,144 rows over
           65,536 keys, flush 128,000) through the manager: `ups` against
           the newest version of each key, kernel A with the validity mask.
           Every sealed segment's planes leave REALTIME_PLANES and every
           executor's cache at its commit, and no retirement raises. Rows/s
           per manager, feed_us_per_row (decode + transform + index; the
           Kafka cell's apart from the in-memory topics' cells), build
           and load ms, freshness, the cold query after a commit, election,
           download and re-election ms, bytes freed
  index_checks
           the star-tree queries' routes (rewritten but for st_bypass),
           st_q2's scanned rows equal to the views' ASIA rows and
           st_bypass's to q1's; ix_vec's recall@100 against the exact
           cosine top-100 of each segment (at least 0.95); each index
           query's mask planes, their bytes and the host ms of evaluating
           them
  mse      the multi-stage engine over ssb, through the same
           execute_sql, each statement once with its launches, device
           dispatches, host fetches, pair-join calls and per-stage stats
           (workers, rows, join_impl, host_crossings, wall ms), its rows
           held against a numpy oracle:
             q8, q9j, q10                       bench.py Q8, Q9J and Q10
                 verbatim: two (three) columnar scan leaves and one fused
                 join+aggregate stage on the card (q9j a LEFT join with a
                 build-side residual as a mask; q10's middle join absorbed,
                 its values gathered on the card); one host crossing each
             mse_pairs                          a join returning rows: the
                 pair join (device_join_indices, gather_payload) on the
                 card in each of its 2 join workers (about 4.4M key rows
                 each), the sort on the host
             mse_agg                            bench.py Q2 under SET
                 useMultistageEngine = true: the leaf partial aggregate runs
                 the single-stage family (kernel A), the final on the host
             f13                                PERCENTILE(lo_revenue, 90) by
                 s_region over `ssbz` with no SET: the single-stage planner
                 refuses the raw column, execute_sql retries on the
                 multi-stage engine, whose scan leaves dispatch on the card
                 (rows, leaf dispatches, docs scanned)
  cache    the caches on (PINOT_TPU_SEGMENT_CACHE=1 and
           PINOT_TPU_RESULT_CACHE=1 around this phase alone, both cleared
           first; every other phase runs with both 0, so a warm run still
           dispatches, launches and fetches as before the caches existed):
           per case the cold run, the warm run's hits, misses, device
           dispatches, host fetches and launches, the warm p50 cached and
           with the cache opted out by SET, every run's rows against the
           oracle and a hit's rows equal to the recompute's: q2_family (a
           full hit: no dispatch, no fetch), a partial overlap of its
           family (1 member cached, a new family of 3), q3 (the merged
           sparse table, then the device-resident per-segment tables alone:
           no dispatch, the device combine), rt_q2 after one more
           generation (the 4 committed segments hit, the snapshot runs
           kernel B), ups after overwrites of committed keys (the
           committed segment misses: its validity plane is in the key; the
           fingerprints' ms), q8 and mse_agg through the multi-stage result
           cache (a hit: no dispatch), and mse_agg's leaf served by the
           partial cache with the result cache off
  coalesce cross-query coalescing of q2_family (both caches off), from 1,
           2, 4, 8 and 16 client threads: a structure round per count (the
           group closing when its N-th member joins: one dispatch and one
           launch of kernel A for the N queries, each response saying
           num_coalesced_queries N - 1; kernel A's group inputs recorded at
           N = 8 and 16, S * Q = 32 and 64 members); then closed-loop
           clients with PINOT_TPU_COALESCE_WINDOW_MS = 2 and MAX_QUERIES =
           N, and with the window at 0, over identical SQL and over a mix
           of region literals: p50 and p99 ms, queries/s, rows/s,
           dispatches a query, groups formed, the [S*Q] plane bytes built;
           every response's rows against the oracle
  explain  EXPLAIN PLAN FOR and EXPLAIN IMPLEMENTATION FOR of q1, q2,
           q2_family, q3, q5, sel_order, mv_group, st_q2, ix_text and rt_q2
           on the card equal to a CPU executor's rows; EXPLAIN ANALYZE of
           q2_family, q2 and q8: one family_dispatch span per dispatch of
           the untraced run, each on cuda with deviceExecMs > 0, a traced
           run's rows equal to the oracle's; an untraced warm q2_family
           makes no synchronize, no span and one host fetch
  host_engine
           the host engine (engine/host_executor.py, engine/funnel.py, the
           inverted, sorted, range and geo index readers) and the
           QueryExecutor backends, HOST_THREADS worker threads each:
           backend "host" over `ssb` (q1, q2_family) and over `clicks` (4
           x 2^21 rows of a clickstream after Pinot's funnel documentation,
           built in the index_data pool: user_id, url of 8 pages, ts raw
           with a range index, s_region with an inverted index, lat / lng
           raw with a geo index, lo_revenue): FUNNELCOUNT by s_region, a
           windowed FUNNELMAXSTEP, the inverted-index EQ and IN, the raw
           RANGE and ST_DISTANCE(lat, lng, ...) < r, no dispatch and no
           launch; backend "auto" over `clicks` (the EQ, IN and RANGE one
           family dispatch and one launch of kernel A each, the funnels and
           the geo filter on the host engine) and over `ssb_rt` with the
           consuming snapshot refused (SET realtimeDevicePlanes = false:
           the committed family one launch of kernel A, the snapshot on the
           host engine); each query timed once, every row against its
           numpy oracle, each launch against its plain version. A
           PurgeTask (minion) over a raw STRING filter, which the planner
           refuses and the host engine evaluates, on a card server: the
           purged segment's rows equal the oracle's. `python -m
           pinot_tpu_torch.tools.admin quickstart --once` in a child
           process (started first, run beside the queries), its servers on
           the card: its demo rows equal the oracle's
  cluster  the cluster serving path (cluster/): a PropertyStore, a
           controller, 2 ServerInstance(device="cuda") and a Broker over
           loopback, table `ssb` registered from phase `data`'s segment
           directories at replication 1 (no new build); q1, q2 (kernel B on
           each segment), q2_family (kernel A once a server, over its family
           of 2), q3 and sel_limit through the broker, each with its counts
           set to 0 just before it: rows against the oracle, both servers
           responding, dispatches equal to the families each server's
           segments form, the kernels launched through the servers; per
           query the broker p50 and the same query's in-process p50 over
           --iters warm runs, and the wire (DataTable bytes, server
           execute_segments, encode, RPC, decode, route and merge + reduce
           ms, host clock in one process); kernel A's and kernel B's
           recorded inputs against their plain versions. Then replication
           2: the query's first RPC dropped (retried on the replica), a
           corrupt DataTable (retried), a server's error (the query fails,
           or answers partial with allowPartialResults, as the JAX broker
           does), and the server that answered q2_family stopped (the
           other replica alone answers it)
  flight_recorder
           the flight recorder and the regression sentinel on phase
           `cluster`'s 2 card servers (replication 1), its line printed
           after `cluster`'s: the compile registry, family guard and AOT
           state emptied as in a fresh process, the AOT cache on in this
           run's directory; with PINOT_TPU_TRACE_SAMPLE = 1.0, q2_family
           (kernel A on each server's family) and q2 (kernel B a segment)
           through the broker, counts set to 0 just before each: rows
           against the oracle, the trace retained as `sampled` with the
           broker's and both servers' spans, its Chrome export checked
           (matched B/E pairs, scatter and gather flows), each kernel call
           against its plain version; q2_family's broker p50 over --iters
           at sampling 0 and 1.0 in turns; the sentinel: a baseline, a
           50 ms `device.dispatch` delay until `latency-drift` fires (at
           most 12 rounds of 6 queries), its exemplar traces, the clean
           rounds that clear it (judged on them alone: the reference is
           persisted before the fault and the ledger restarts from it
           after), the ledger persisted and restored; the
           registry's dispatches against the responses' and each family's
           cold ms; q2_family twice in two child processes on the card
           (side by side) over Server_0's segments, one prewarmed from
           this run's AOT
           records and one not (prewarm ms, families loaded, first and
           second query ms, aotCacheHits)
  mse_cluster
           the cluster multi-stage engine (mse/distributed.py) on phase
           `cluster`'s layout, its store behind a PropertyStoreServer: q8,
           q10, mse_agg and mse_agg_solo (mse_agg with SET segmentBatch =
           false) through the broker, each once with its counts set to 0
           just before it: rows against the oracle, stage workers on both
           servers, kernel A once a server on mse_agg and kernel B once a
           segment on mse_agg_solo (their inputs against the plain
           versions), and on q8 and q10 the join workers' pair join on the
           card (forced: PINOT_TPU_DEVICE_JOIN=1), PTDP exchange bytes and
           pack_u8_wire given card tensors; per statement the broker p50
           over --iters warm runs beside phase `mse`'s in-process p50, per
           stage workers, wall ms, shuffled rows and bytes and PTDP bytes,
           and the mailbox peak; a `mailbox.deliver` failure (the re-sent
           chunk dropped, rows equal); a server in a second OS process on
           the card joining through RemoteStore, and q8 over `ssb_l` (an
           in-process server) JOIN `ssb_r` (the child); a crashed server:
           q8 fails within its timeoutMs, every mailbox store emptied
  admission_tiers
           the broker's admission layer and the servers' tiered storage on
           clusters of their own over `ssb`: 16 closed-loop clients against
           a gate of 2 in flight and 2 queued (each answer the oracle's or a
           rejection, the queriesRejected meter, the in-flight gauge's peak,
           admitted p50 / p99, the queue wait, the gate's cost an admit);
           under a burst of 20 a QPS quota of 5 on q2_family and of 1 on q8
           through the cluster MSE; sel_limit through a cursor in pages of
           1000; a
           LIMIT 100 selection streamed and stopped early; q2_family with
           each primary RPC delayed 250 ms, unhedged and hedged at 20 ms
           (p50 / p99, rows bit-identical, hedges, wins, the losers'
           cancels); then tarred segments on servers whose tier holds one
           of their two: the cold first q2_family (coldLoadMs), an eviction
           pass (the card's bytes freed) and the fetch again, a corrupt
           cold fetch quarantined and repaired, a StoragePrefetcher nudge
           fed by the broker's beacon (prefetch hits, the AOT prewarm), q2
           with kernel B a warmed segment, mse_agg's leaves warming a cold
           segment, and the disk against the budget at every step
  operations
           the operations layer on the card over loopback HTTP, a cluster
           of its own over `ssb` (2 card servers, replication 1, a third
           that joins): REST p50 of q2_family against Broker.execute_sql's,
           q2_family (kernel A) and q2 (kernel B) over POST /query/sql with
           the oracle's rows, a 1 qps quota's rejection, a shed query's
           429, BasicAuth's 401 and 403, /metrics as Prometheus text, every
           /debug route; POST /tables/ssb/rebalance moving a segment onto
           the joiner under a REST client (every answer the oracle's, no
           segment below one routable replica) and the source's device
           bytes freed; a drain of Server_0 whose first destination fetch
           a rebalance.move fault corrupts (quarantined, repaired by the
           SegmentIntegrityChecker's nudge, the job DONE), kernel A over
           the destination's family; a lineage swap of ssb_0 to a renamed
           copy under a REST client (rows counted once, the old planes
           released); the fleet health scrape (each server's device bytes
           equal to its cache's) flagging a delayed server straggler, and
           /debug/cluster; build_default_scheduler's tasks run once each,
           their ms
  batch_ingest
           an analyst's nightly batch load, after Pinot's batch ingestion
           job spec (SegmentCreationAndTarPush): 4 input files of 2^19
           lineorder rows (gen_ssb from --seed + 20), gzipped CSV, JSON
           lines, Avro (deflate) and Thrift, written by the spawn pool
           after phase data's builds; IngestionJobLauncher's multiprocess runner (4
           spawned workers, file:// in and out) builds and tars one segment
           a file, timed per format in the worker (read, transform, build,
           tar + copy); push_segments_to_cluster to 2 card servers at
           replication 1, one tarball moved to an s3:// deep store first
           (S3PinotFS over an in-memory client, registered with
           register_fs), each server fetching, untarring and loading
           through its tier (ms each; the fetch is the file system's
           open, the untar streams from it); q2_family (kernel A over each
           server's family of 2) cold and warm, q2 with segmentBatch =
           false (kernel B a segment) and COUNT(*) = 2,097,152 with the
           oracle's rows, the bytes on the card; a StreamingSegmentWriter
           sink (2^18 rows, a segment every 2^17) pushing into a second
           table on one server, q2_family there (kernel A over its family
           of 2); the minion (minion/) on that server's table: a
           MergeRollupTask (concat) swaps the 2 sink segments for one
           2^18-row segment through lineage, q2_family over it with the
           pre-merge answer (one launch), then a PurgeTask evaluates a
           filter of about 1.1% of rows on the merged segment's planes on
           the card and swaps in the rest, q2_family with the oracle's rows
           of what is left; each task's ms, build ms, swap ms and the card
           bytes freed from the replaced segments;
           client.connect(url).execute(q2_family) against a
           BrokerRestServer; read_table (the servers' scan_arrow),
           scan_table and read_sql where pyarrow is importable (it is on
           the card's machine)
  soak     the soak harness (pinot_tpu_torch/tools/soak.py) through its
           entry points on the card: soak_sql (the fuzz table at 2^16
           rows, SOAK_SQL_CHECKS checks: the host engine against sqlite,
           backend "auto" on the card against the host engine); soak_qps
           under backend "device" (3 card servers, replication 2, 6
           segments of 2^21 rows, the 5 query families at 50 queries/s
           from 8 workers for 20 s), then under corrupt_rate 0.02 for 6 s
           over 6 segments of 2^19 rows (every corruption detected); and
           soak_realtime (one committer-crash round, 10 s of device churn
           on a consuming segment). Each suite's summary, checks or
           queries a second, p50 / p99, device dispatches, launches (set
           to 0 just before each suite) counted by shape, and seconds; the
           first SOAK_KEEP inputs of each kernel shape against the plain
           versions; its kernel rows timed right after it
  mesh     parallel/mesh.py on the one card named four times (cuda:0 x 4):
           q2's plan over the first ssb segment (2^23 rows) row-split
           into 4 shards, kernel B at row offsets 0, 2^21, 2^22, 3 * 2^21,
           each launch element-equal to its plain version, the merged
           table equal to the solo fused run and the segment's numpy
           oracle; q2_family through QueryExecutor(mesh_devices=cuda:0 x
           4) over the ssb family (dp = 4): one dispatch, kernel A once a
           shard (each against its plain version), one host fetch, the
           oracle's rows, the packed buffer byte for byte the solo
           family's, crossChipCombineMs and the per-device stamps of a
           traced run, SET meshExecution = false giving the same rows;
           the native host library (segment/native_bridge.py): the ssbz
           LZ4 / Snappy buffers re-encoded to the stored bytes and decoded
           by the library and by the Python codecs alike, and a 2^23-value
           13-bit plane packed and unpacked as numpy does, with the MB/s
           of each beside the Python codecs' and numpy's in the same run
  doctor   `python -m pinot_tpu_torch.tools.doctor`'s probe (a supervised
           child: the card, the kernel build, kernel A against its plain
           version) must classify `ok`; the child runs while phase
           index_data waits on the build pool, its line prints here
  mse_layers
           per statement: parse + plan, the leaf stages, the join stage
           and the rest (shuffles, final aggregate, sort), host clock over
           the `times` runs
  join_ops the fused stages' torch ops of q8 and q10 alone on the inputs
           the statements gave them: device ms (torch.profiler, each call
           after a 256 MB write), the bytes they must move and the bound at
           3.35 TB/s
  sync_debug
           one q8 with torch.cuda.set_sync_debug_mode("warn"): the
           synchronizing calls inside its fused stage
  times    p50 query latency over --iters warm runs (1 for a query slower
           than 1 s), the multi-stage statements included; q6, q6m and
           q6_sort are left out (host-held: their rows, dispatches and
           launches are held in `queries`)
  layers   a warm query's host time split into parse + prune + plan,
           dispatch, collect (the query's one fetch and the decode) and
           combine + reduce, medians of 3 runs (1 for a query slower than
           1 s); q6, q6m
           and q6_sort are left out (host-held, PERF.md §5)
  profile  device busy share and the top device kernels under
           torch.profiler (one warm run a query; q6, q6m and q6_sort left
           out)
  chain    time_raw's MONTH(lo_commit_ts) chain alone over the family's raw
           plane: its time, the torch kernels it launches, the bytes they
           move against one fused pass's
  oom      device-memory relief under torch.cuda.set_per_process_memory_
           fraction: q4's 16 segments made cold, a cap a quarter of q4's
           uploads above what is reserved, so q4 runs only after one relief
           (rows equal to the oracle); then a cap 1 MiB above an emptied
           card's reservation: q4 fails alone with HbmExhaustedError, and
           q2_family answers once the cap is lifted; the caps, the bytes
           freed and the relief's ms
  geometry each kernel shape's launch geometry and the card's cluster
           occupancy
  total    the run's wall time, the build included
  kernels  the kernel table (the realtime, ingest and index queries'
           launches included, one row each, kernel A over a cluster server's
           family of 2, kernels A and B head-sampled through the cluster
           (phase flight_recorder), kernels A and B through the cluster
           multi-stage engine's leaves, kernels A and B through phase
           admission_tiers' tiered and hedged paths, kernels A and B
           through phase operations' REST, moved and swapped segments, and
           kernels A and B over phase batch_ingest's pushed and sunk
           segments, kernel A under phase host_engine's backend "auto",
           kernel A (and B where it ran) under phase soak's sql and qps
           suites):
           per kernel and
           main-path shape, the kernel's
           own device time per launch (`ms`, torch.profiler, 20 launches
           rotated over the recorded inputs of the query's segments or
           families and, where those are small, fresh copies of them, so
           that the 50 MB L2 holds none of them), the wrapper's time with
           CUDA events around the calls (`call_ms`), the bound over the rows
           the function needs (a consuming snapshot's live rows, not its pad
           bucket; `padded_bound_ms` counts the whole padded input) and its
           share, the plain version's time and one PyTorch library call
           computing the same sums, both rotated over the same inputs

Every phase line carries `seconds`: the host time since the previous
phase line, or the phase's own where it measures one. The line before the
last is the kernel table, the last line
{"ok": true, "device": {...}}. Any failure raises and the script exits
non-zero without that line. It exits non-zero at once when no CUDA device
is present or the pinot_tpu_torch package is not beside it.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import gc
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np

DEVICE = "cuda"

# NVIDIA H100 SXM data sheet figures (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # the card's non-tensor-core peak, used for int32 ops
L2_BYTES = 50 * (1 << 20)

SCHEMA_DIMS = [("d_year", "INT"), ("p_brand", "INT"), ("s_region", "STRING"),
               ("lo_discount", "INT"), ("lo_quantity", "INT"),
               ("lo_orderkey", "INT")]
SCHEMA_METRICS = [("lo_extendedprice", "INT"), ("lo_revenue", "INT")]
RAW_COLUMNS = ["lo_extendedprice", "lo_revenue", "lo_quantity"]
REGIONS = ["AMERICA", "ASIA", "EUROPE", "AFRICA", "MIDDLE EAST"]

Q1 = ("SELECT SUM(lo_extendedprice) FROM ssb WHERE d_year = 1993 "
      "AND lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25")
Q2 = ("SELECT d_year, p_brand, SUM(lo_revenue) FROM ssb "
      "WHERE s_region = 'ASIA' GROUP BY d_year, p_brand LIMIT 10000")
Q9 = ("SELECT d_year, p_brand, SUM(lo_revenue), SUM(lo_extendedprice), "
      "SUM(lo_quantity) FROM ssb WHERE s_region = 'ASIA' "
      "GROUP BY d_year, p_brand LIMIT 10000")
Q2_UNFUSED = "SET useFusedKernel = false; " + Q2
FLAGSHIP = ("SELECT p_brand, SUM(lo_revenue), COUNT(*), MIN(lo_revenue), "
            "MAX(lo_revenue) FROM ssb WHERE d_year >= 1995 "
            "GROUP BY p_brand LIMIT 1000")
# bench.py Q3, verbatim
Q3 = ("SET numGroupsLimit = 20000000; "
      "SELECT lo_orderkey, SUM(lo_revenue), COUNT(*) FROM ssb "
      "GROUP BY lo_orderkey ORDER BY lo_orderkey LIMIT 100000")
# each segment of 2^23 rows holds about 1.05M distinct lo_orderkey, under
# the dense limit (2^21): the reference's own switch sends it sparse
SPARSE = "SET sparseGroupBy = true; "
Q3_SORT = ("SELECT d_year, lo_orderkey, SUM(lo_revenue), COUNT(*), "
           "MIN(lo_revenue), MAX(lo_revenue) FROM ssb "
           "GROUP BY d_year, lo_orderkey ORDER BY d_year, lo_orderkey "
           "LIMIT 100000")
SPARSE_FAMILY = ("SELECT p_brand, SUM(lo_revenue), COUNT(*), "
                 "MIN(lo_revenue), MAX(lo_revenue) FROM ssb "
                 "GROUP BY p_brand ORDER BY p_brand LIMIT 1000")
# the queries as measured before batch families existed: one dispatch per
# segment, kernel B on q2 / q9
NO_BATCH = "SET segmentBatch = false; "
# bench.py's ssb16: the same rows in 16 segments
FAMILY_TABLE, FAMILY_SEGMENTS = "ssb16", 16
QUERIES = {"q1": NO_BATCH + Q1, "q2": NO_BATCH + Q2, "q9": NO_BATCH + Q9,
           "q2_unfused": NO_BATCH + Q2_UNFUSED,
           "flagship": NO_BATCH + FLAGSHIP,
           "q2_family": Q2, "flagship_family": FLAGSHIP,
           "q3": SPARSE + Q3, "q3_sort": Q3_SORT,
           "q4": Q2.replace("FROM ssb", f"FROM {FAMILY_TABLE}"),
           "q3m": SPARSE + Q3.replace("FROM ssb", f"FROM {FAMILY_TABLE}"),
           "sparse_family": SPARSE + SPARSE_FAMILY.replace(
               "FROM ssb", f"FROM {FAMILY_TABLE}")}
# bench.py Q5 and Q6, verbatim (Q6 over ssb and ssb16)
TAXI_TABLE = "taxi"
Q5 = ("SELECT pickup_day, DISTINCTCOUNT(passenger_count), "
      "PERCENTILETDIGEST(fare, 95) FROM taxi GROUP BY pickup_day LIMIT 1000")
Q5_TOTAL = ("SELECT DISTINCTCOUNT(passenger_count), PERCENTILETDIGEST(fare, 50), "
            "HISTOGRAM(fare, 0, 100, 20) FROM taxi")
AGGMIX = ("SELECT d_year, DISTINCTCOUNT(p_brand), DISTINCTCOUNTHLL(p_brand), "
          "PERCENTILE(lo_discount, 90), MODE(lo_discount), "
          "HISTOGRAM(lo_quantity, 0, 50, 10), PERCENTILETDIGEST(lo_revenue, 95), "
          "STDDEVPOP(lo_extendedprice), CORR(lo_quantity, lo_revenue) "
          "FROM ssb WHERE s_region = 'ASIA' GROUP BY d_year LIMIT 100")
Q6 = ("SET numGroupsLimit = 100000; "
      "SELECT lo_orderkey, DISTINCTCOUNT(lo_discount), SUM(lo_revenue) "
      "FROM ssb GROUP BY lo_orderkey ORDER BY lo_orderkey LIMIT 100000")
Q6_SORT = ("SET numGroupsLimit = 100000; "
           "SELECT d_year, lo_orderkey, DISTINCTCOUNT(lo_discount) FROM ssb "
           "GROUP BY d_year, lo_orderkey ORDER BY d_year, lo_orderkey "
           "LIMIT 100000")
QUERIES.update({"q5": Q5, "q5_total": Q5_TOTAL, "aggmix": AGGMIX, "q6": Q6,
                "q6m": Q6.replace("FROM ssb", f"FROM {FAMILY_TABLE}"),
                "q6_sort": Q6_SORT})
# the SET segmentBatch = false twins of the queries whose segments batch
# (q3, q3_sort and q3m batch nothing: each segment's key space differs, so
# each is a family of one either way)
QUERIES.update({"q4_solo": NO_BATCH + QUERIES["q4"],
                "sparse_family_solo": NO_BATCH + QUERIES["sparse_family"]})
# selections and segment pruning on ssb (lo_orderkey is sorted in
# ingestion order, so the segments hold disjoint key ranges; the BETWEEN
# range lies inside the second segment's)
QUERIES.update({
    "sel_limit": "SELECT lo_orderkey, d_year, lo_revenue FROM ssb "
                 "WHERE s_region = 'ASIA' AND lo_quantity < 25 LIMIT 1000",
    "sel_order": "SELECT lo_orderkey, lo_revenue FROM ssb WHERE d_year = 1993 "
                 "AND lo_quantity < 3 ORDER BY lo_revenue DESC, lo_orderkey "
                 "LIMIT 100",
    "sel_pruned": "SELECT lo_orderkey, lo_revenue FROM ssb "
                  "WHERE lo_orderkey BETWEEN 1500000 AND 1500999 LIMIT 1000",
    "agg_all_pruned": "SELECT COUNT(*), HISTOGRAM(lo_revenue, 0, 1000000, 4) "
                      "FROM ssb WHERE lo_orderkey < 0"})
# the multi-value table: ssb's columns plus lo_tags
MV_TABLE, MV_CARD, MV_MAX = "mvt", 1000, 4
MV_TAGS = (3, 17, 42)
QUERIES.update({
    "mv_filter": "SELECT d_year, COUNT(*), SUM(lo_revenue) FROM mvt "
                 "WHERE lo_tags IN (3, 17, 42) GROUP BY d_year",
    "mv_group": "SELECT lo_tags, COUNT(*), SUM(lo_revenue) FROM mvt "
                "WHERE s_region = 'ASIA' GROUP BY lo_tags LIMIT 2000",
    "mv_aggs": "SELECT d_year, COUNTMV(lo_tags), SUMMV(lo_tags), "
               "MINMV(lo_tags), MAXMV(lo_tags), AVGMV(lo_tags), "
               "MINMAXRANGEMV(lo_tags) FROM mvt GROUP BY d_year"})
# the matrix-shaped MV functions: the JAX package's device planner refuses
# them, and so does the port's single-stage planner (execute_sql would
# retry them on the multi-stage engine, as the JAX package does)
MV_REFUSED = ("SELECT d_year, DISTINCTCOUNTMV(lo_tags) FROM mvt GROUP BY d_year",
              "SELECT d_year, PERCENTILEMV(lo_tags, 90) FROM mvt "
              "GROUP BY d_year")
# the transform registry: bench.py Q7 verbatim over the `brands`
# dimension table (bench.py's, built here: 1000 rows), and `ssbt`, the ssb
# rows plus two TIMESTAMP columns: lo_orderdate, a day of the row's d_year
# (dictionary-encoded, 2557 days, as SSB's date dimension over 1992-1998),
# and lo_commit_ts, lo_orderdate plus up to 90 days in millis (raw)
TIME_TABLE, DIM_TABLE = "ssbt", "brands"
N_BRANDS, BRAND_CATEGORIES = 1000, 40
DAY_MS = 86_400_000
QUERIES.update({
    "q7": "SELECT d_year, LOOKUP('brands', 'b_category', 'b_id', p_brand), "
          "SUM(lo_revenue) FROM ssb "
          "WHERE LOOKUP('brands', 'b_region', 'b_id', p_brand) = 'ASIA' "
          "GROUP BY d_year, LOOKUP('brands', 'b_category', 'b_id', p_brand) "
          "LIMIT 1000",
    "time_group": "SELECT DATETRUNC('MONTH', lo_orderdate), COUNT(*), "
                  "SUM(lo_revenue) FROM ssbt WHERE s_region = 'ASIA' "
                  "GROUP BY DATETRUNC('MONTH', lo_orderdate) LIMIT 100",
    "str_group": "SELECT toDateTime(lo_orderdate, 'yyyy-MM'), LOWER(s_region), "
                 "COUNT(*), SUM(lo_revenue) FROM ssbt "
                 "WHERE SUBSTR(s_region, 0, 1) = 'A' "
                 "GROUP BY toDateTime(lo_orderdate, 'yyyy-MM'), LOWER(s_region) "
                 "LIMIT 1000",
    "time_raw": "SELECT d_year, COUNT(*), SUM(toEpochDays(lo_commit_ts) - "
                "toEpochDays(lo_orderdate)) FROM ssbt "
                "WHERE MONTH(lo_commit_ts) = 12 GROUP BY d_year",
    "post_agg": "SELECT d_year, ROUNDDECIMAL(SUM(lo_revenue) / COUNT(*), 1) "
                "FROM ssb GROUP BY d_year ORDER BY d_year"})
# shapes the single-stage planners of both packages refuse (the refusal is
# checked through QueryExecutor.execute): a GROUP BY on a transform of a
# raw column, and a transform of two dictionary columns past the 2^18-entry
# table
TRANSFORM_REFUSED = (
    "SELECT YEAR(lo_commit_ts), COUNT(*) FROM ssbt GROUP BY YEAR(lo_commit_ts)",
    "SELECT lo_orderkey + toEpochDays(lo_orderdate), COUNT(*) FROM ssbt "
    "GROUP BY lo_orderkey + toEpochDays(lo_orderdate) LIMIT 10")
# F13 (phase mse): the single-stage planner refuses PERCENTILE over the raw
# lo_revenue; execute_sql answers it on the multi-stage engine. Over `ssbz`
# (phase segment_formats' 4 x 2^21 rows, lo_revenue raw under LZ4) since
# phase host_engine joined the run: over ssb's 2^25 rows it took 17.4 to
# 28.3 s, nearly all the multi-stage engine's host work on object strings
F13_SQL = ("SELECT s_region, PERCENTILE(lo_revenue, 90) FROM ssbz "
           "GROUP BY s_region ORDER BY s_region")
# the transform queries that launch a new kernel A shape, one launch each
TRANSFORM_QUERIES = ("q7", "time_group", "str_group", "time_raw")
# phase timeseries: m3ql queries over `ssbt` through the timeseries
# engine, in process and over the broker's REST route; (query, start, end,
# step). The fetch groups by `lo_orderdate - MOD(lo_orderdate, step)` over
# the dictionary (and the tags): kernel A over the family of 4
WEEK_MS = 7 * DAY_MS
TS_START = 694_224_000_000 // WEEK_MS * WEEK_MS  # 1992-01-01, to the week
TS_END = 915_148_800_000  # 1999-01-01
TS_MONTH_MS = 30 * DAY_MS
TS_QUERIES = {
    "ts_weekly": ("fetch table=ssbt value=lo_revenue time_col=lo_orderdate "
                  "filter=\"lo_quantity < 25\" | sum s_region | moving_avg 4 "
                  "| topk 3", TS_START, TS_END, WEEK_MS),
    "ts_daily_max": ("fetch table=ssbt value=lo_revenue "
                     "time_col=lo_orderdate agg=max | max s_region",
                     TS_START, TS_END, DAY_MS),
    # 1991-01-01 to 2000-01-01 in 30-day buckets: empty at both ends
    "ts_count": ("fetch table=ssbt value=lo_revenue time_col=lo_orderdate "
                 "agg=count filter=\"lo_discount < 2\" | sum "
                 "| transform_null 0",
                 662_688_000_000 // TS_MONTH_MS * TS_MONTH_MS,
                 946_684_800_000, TS_MONTH_MS)}
# the same fetch over the raw lo_commit_ts: neither package's device
# planner lowers the bucket over a raw column
TS_RAW = ("fetch table=ssbt value=lo_revenue time_col=lo_commit_ts "
          "| sum s_region", TS_START, TS_END, WEEK_MS)
# phase segment_formats: `ssbz`, the ssb rows in FORMATS_SEGMENTS segments
# of FORMATS_ROWS, segment k holding the rows whose lo_orderkey is k modulo
# FORMATS_SEGMENTS (a stream partitioned on the key, stamped modulo), built
# with compressed forward indexes, a raw var-width note, a CLP log column
# and a bloom filter, and registered under a schema that adds two columns
FORMATS_TABLE, FORMATS_SEGMENTS, FORMATS_ROWS = "ssbz", 4, 1 << 21
FORMATS_DIMS = [("d_year", "INT"), ("p_brand", "INT"), ("s_region", "STRING"),
                ("lo_orderkey", "INT"), ("lo_note", "STRING"),
                ("lo_log", "STRING")]
FORMATS_METRICS = [("lo_extendedprice", "INT"), ("lo_revenue", "INT")]
FORMATS_ADDED_DIMS, FORMATS_ADDED_METRICS = [("s_nation", "STRING")], \
    [("lo_tax", "INT")]
FORMATS_CODECS = {"lo_revenue": "LZ4", "lo_extendedprice": "SNAPPY",
                  "p_brand": "GZIP", "lo_log": "CLP"}
FORMATS_RAW = ["lo_revenue", "lo_extendedprice", "lo_note", "lo_log"]
FORMATS_NUMERIC = ("d_year", "p_brand", "s_region", "lo_orderkey",
                   "lo_extendedprice", "lo_revenue", "lo_quantity",
                   "lo_discount")
# machine-log lines of four templates (by lo_discount), their variables of
# low cardinality, as a service's repeated messages are
LOG_TEMPLATES = ("INFO order shipped qty={q} brand=MFGR#{b} year={y}",
                 "WARN order delayed {q} days at dc{b}",
                 "ERROR task_{q} failed after {y}.{b}s",
                 "INFO user u{b} paid {q}.50 USD")
# a region no row holds, between the columns' min and max: only the bloom
# filters prune it
BLOOM_PROBE = "ANTARCTICA"
FORMATS_QUERIES = {
    "z_year": "SELECT d_year, SUM(lo_revenue) FROM ssbz GROUP BY d_year",
    "z_q2_family": Q2.replace("FROM ssb", "FROM ssbz"),
    "z_q2": NO_BATCH + Q2.replace("FROM ssb", "FROM ssbz"),
    "z_evolved": "SELECT s_nation, SUM(lo_tax), COUNT(*) FROM ssbz "
                 "GROUP BY s_nation",
    "z_select": "SELECT lo_note, lo_log, lo_revenue FROM ssbz "
                "WHERE d_year = 1995 LIMIT 10",
    "z_bloom": f"SELECT COUNT(*) FROM ssbz WHERE s_region = '{BLOOM_PROBE}'",
    "z_partition": "SELECT COUNT(*), SUM(lo_revenue) FROM ssbz "
                   "WHERE lo_orderkey = {key}",
}
# the kernel each query must launch (q1 is ungrouped: it launches neither;
# the sparse GROUP BYs run torch ops)
EXPECTED_KERNEL = {"q2": "fused_limb_sums", "q9": "fused_limb_sums",
                   "q2_unfused": "limb_sums", "flagship": "limb_sums",
                   "q2_family": "limb_sums", "flagship_family": "limb_sums",
                   "q4": "limb_sums", "q4_solo": "fused_limb_sums",
                   "q5": "limb_sums", "q5_total": "limb_sums",
                   "aggmix": "limb_sums", "mv_filter": "limb_sums",
                   "mv_group": "limb_sums", "mv_aggs": "limb_sums",
                   "q7": "limb_sums", "time_group": "limb_sums",
                   "str_group": "limb_sums", "time_raw": "limb_sums",
                   "post_agg": "limb_sums"}
# one batch family: one dispatch, one launch of kernel A per pass (one
# fetch holds for every query)
ONE_FAMILY = ("q2_family", "flagship_family", "q4", "sparse_family", "q5",
              "q5_total", "aggmix", "sel_limit", "sel_order", "mv_filter",
              "mv_group", "mv_aggs", "q7", "time_group", "str_group",
              "time_raw", "post_agg")
# segments pruned, and the dispatches left
PRUNED = {"sel_pruned": (3, 1), "agg_all_pruned": (4, 0)}
# kernel A's passes over a family: the sums (counts) pass, then one pass per
# occupancy or value histogram and two per adaptive histogram
FAMILY_LAUNCHES = {"q5": 4, "q5_total": 3, "aggmix": 5}
SPARSE_QUERIES = ("q3", "q3_sort", "q3m", "sparse_family",
                  "sparse_family_solo", "q6", "q6m", "q6_sort")
DEVICE_COMBINE = ("q3", "q3m", "sparse_family", "sparse_family_solo")
# results in ORDER BY order, compared row for row
ORDERED = ("q3", "q3_sort", "q3m", "sparse_family", "sparse_family_solo",
           "q6", "q6m", "q6_sort", "sel_limit", "sel_order", "sel_pruned",
           "post_agg")
# the queries whose kernel A passes the kernel table times shape by shape
MATRIX_QUERIES = ("q5", "q5_total", "aggmix")
# their kernel A passes in launch order
PASS_LABELS = {"q5": ("counts", "distinct", "percentile pass 1",
                      "percentile pass 2"),
               "q5_total": ("distinct", "percentile pass 1",
                            "percentile pass 2"),
               "aggmix": ("sums", "distinct", "value histogram",
                          "percentile pass 1", "percentile pass 2")}
# the MV queries' kernel A launches, one a query (a family of 4)
MV_QUERIES = ("mv_filter", "mv_group", "mv_aggs")
# the realtime tables: `ssb_rt`, the 4 ssb segments (the same objects) and
# one consuming segment with the ssb schema fed a row at a time through
# MutableSegment.index, in three generations (g0 ends just below the 2^19
# bucket, g1 crosses into 2^20, g2 adds a small tail); `ups`, an upsert
# table (FULL, comparison column ts) of one committed segment and one
# consuming segment, then overwritten with UPS_OVERWRITE more rows. Both
# were halved when phase `ingest` joined the run (from g0 2^22 - 2^15, g1
# 2^16, and 2^21 rows a ups segment over 2^20 keys with 2^16 overwrites)
# and quartered when phase `soak` did (from g0 2^21 - 2^14, g1 2^15, and
# 2^20 rows a ups segment over 2^19 keys with 2^15 overwrites; the
# row-at-a-time feed and the upsert replay took 51.9 s of the phase's
# 56.8), to keep the run inside its time limit; the tables' width is
# unchanged
RT_TABLE, UPS_TABLE = "ssb_rt", "ups"
RT_GENERATIONS = (("g0", (1 << 19) - (1 << 13)), ("g1", 1 << 14),
                  ("g2", 1 << 10))
UPS_ROWS, UPS_KEYS, UPS_OVERWRITE = 1 << 18, 1 << 17, 1 << 13
UPS_STALE_EVERY = 64  # one row in 64 arrives older than every version
# phase `cache`: rows fed to ssb_rt's consuming segment after the realtime
# phase (a new generation), and ups overwrites of committed keys
RT_NEXT_GENERATION, UPS_CACHE_OVERWRITE = 1 << 10, 1 << 10
RT_QUERIES = {
    "rt_q1": Q1.replace("FROM ssb", f"FROM {RT_TABLE}"),
    "rt_q2": Q2.replace("FROM ssb", f"FROM {RT_TABLE}"),
    # a RANGE on a dictionary column: an id interval on the immutable
    # segments, a LUT over the insertion-ordered dictionary on the
    # consuming one
    "rt_range": f"SELECT d_year, COUNT(*), SUM(lo_revenue) FROM {RT_TABLE} "
                "WHERE d_year BETWEEN 1993 AND 1995 GROUP BY d_year",
    "ups": f"SELECT d_year, SUM(lo_revenue), COUNT(*) FROM {UPS_TABLE} "
           "WHERE s_region = 'ASIA' GROUP BY d_year"}
# the realtime queries that launch the kernels (rt_q1 is ungrouped): kernel
# A over the immutable family, or the committed segment, and kernel A or B
# over the consuming snapshot
RT_KERNEL_QUERIES = ("rt_q2", "rt_range", "ups")
# phase `ingest`: realtime tables fed from a stream through the port's
# RealtimeTableDataManager (spi/stream.py, ingestion/transform.py,
# realtime/manager.py, realtime/completion.py). `ingest`: the ssb schema
# from a 2-partition in-memory topic (a clickstream or orders topic feeding
# a dashboard table), keyed by lo_orderkey, INGEST_ROWS rows a partition on
# average published in batches of INGEST_BATCH while the consumers run;
# each segment seals at INGEST_FLUSH_ROWS (Pinot's documented
# realtime.segment.flush.threshold.rows default is 5,000,000; cut for time,
# and a multiple of the in-memory consumer's 1000-message fetch: a sealed
# segment holds that many rows, or up to 999 more where a fetch came back
# short because the consumer had caught up with the producer, as in the
# JAX package; it pads to 2^18). Then two
# replicas of it on one partition through the leader controller's
# completion protocol (REPLICA_* rows, flush REPLICA_FLUSH_ROWS), and an
# upsert table through the manager (UPS_INGEST_*)
INGEST_TABLE, UPS_INGEST_TABLE = "ingest", "ups_ingest"
INGEST_PARTITIONS, INGEST_ROWS, INGEST_BATCH = 2, 288_000, 64_000
INGEST_FLUSH_ROWS = 256_000
INGEST_TRICKLE = 1_000  # rows published after the settle point: freshness
REPLICA_FLUSH_ROWS, REPLICA_TAIL = 256_000, 16_000
REPLICA_COMPLETION = {"num_replicas": 2, "commit_lease_s": 2.0,
                      "decision_wait_s": 1.0}
UPS_INGEST_ROWS, UPS_INGEST_KEYS, UPS_INGEST_FLUSH = 262_144, 65_536, 128_000
INGEST_WAIT_S = 240.0  # the longest any settle point may take
INGEST_QUERIES = {q: RT_QUERIES[q].replace(f"FROM {RT_TABLE}",
                                           f"FROM {INGEST_TABLE}")
                  for q in ("rt_q1", "rt_q2", "rt_range")}
INGEST_QUERIES["ups"] = RT_QUERIES["ups"].replace(
    f"FROM {UPS_TABLE}", f"FROM {UPS_INGEST_TABLE}")
# the index tables: `ssb_st`, the ssb rows with a star-tree of Pinot's
# documented config shape (dimensionsSplitOrder, functionColumnPairs,
# maxLeafRecords default 10,000); `events`, a log/event table of gen_ssb
# rows (EVENTS_SEED) with a JSON (`attrs`), a text (`msg`) and a map
# (`props`) index column; `vecs`, a 384-wide embedding (the width of
# common sentence-embedding models) with a vector index, Gaussian around
# VEC_CENTRES seeded centres
ST_TABLE, EVENTS_TABLE, VEC_TABLE = "ssb_st", "events", "vecs"
ST_CONFIG = {"dimensionsSplitOrder": ["d_year", "s_region", "p_brand"],
             "functionColumnPairs": ["COUNT__*", "SUM__lo_revenue",
                                     "SUM__lo_extendedprice",
                                     "SUM__lo_quantity", "MIN__lo_quantity",
                                     "MAX__lo_quantity"]}
INDEX_SEGMENTS = 4
# worker processes building phase data's tables, the index tables and the
# batch inputs (the card's host has 8 cores, and the main process waits on
# them; 6 before phase `timeseries` joined the run)
INDEX_WORKERS = 7
EVENTS_SEED, VEC_SEED = 2030, 2031
EVENTS_SSB = ("d_year", "p_brand", "s_region", "lo_revenue", "lo_quantity")
EVENTS_DIMS = [("d_year", "INT"), ("p_brand", "INT"), ("s_region", "STRING"),
               ("lo_quantity", "INT"), ("attrs", "JSON"), ("msg", "STRING"),
               ("props", "STRING")]
N_COUNTRIES, MAX_VER, N_TAGS, JSON_TAG = 50, 20, 100, 7
OS_NAMES = ("ios", "android", "linux", "windows")
# a 10,000-word vocabulary drawn by Zipf rank; it holds the phrase
# "connection reset" and three words of the prefix "time"
TEXT_WORDS = [f"w{i}" for i in range(10_000)]
PHRASE_RANKS, PREFIX_RANKS = (40, 41), (300, 1000, 3000)
for _rank, _word in zip(PHRASE_RANKS + PREFIX_RANKS,
                        ("connection", "reset", "time", "timeout",
                         "timestamp")):
    TEXT_WORDS[_rank] = _word
TEXT_ZIPF, PHRASE_EVERY, MAP_ABSENT_EVERY, MAP_CLICKS = 1.3, 64, 11, 40
VEC_DIM, VEC_CENTRES, VEC_NOISE, VEC_K, VEC_RECALL = 384, 256, 0.25, 100, 0.95
# the query vector is drawn by index_tables; its literal is filled in there
VEC_QUERY = ("SELECT d_year, COUNT(*) FROM vecs WHERE VECTOR_SIMILARITY(emb, "
             "ARRAY[{}], " + str(VEC_K) + ") GROUP BY d_year")
ST_QUERIES = ("st_q2", "st_q9", "st_avg", "st_bypass")
INDEX_QUERIES = ("ix_json", "ix_text", "ix_map", "ix_vec")
QUERIES.update({
    "st_q2": Q2.replace("FROM ssb", f"FROM {ST_TABLE}"),
    "st_q9": Q9.replace("FROM ssb", f"FROM {ST_TABLE}"),
    "st_avg": f"SELECT s_region, COUNT(*), AVG(lo_revenue), "
              f"MINMAXRANGE(lo_quantity) FROM {ST_TABLE} "
              "WHERE d_year BETWEEN 1993 AND 1995 GROUP BY s_region",
    # filters lo_discount, not a split dimension: no rewrite
    "st_bypass": Q1.replace("FROM ssb", f"FROM {ST_TABLE}"),
    "ix_json": f"SELECT d_year, COUNT(*), SUM(lo_revenue) FROM {EVENTS_TABLE} "
               "WHERE JSON_MATCH(attrs, '\"$.device.os\" = ''ios'' AND "
               f"\"$.tags[*]\" = ''t{JSON_TAG}''') GROUP BY d_year",
    "ix_text": f"SELECT d_year, COUNT(*), SUM(lo_revenue) FROM {EVENTS_TABLE} "
               "WHERE TEXT_MATCH(msg, '\"connection reset\" OR time*') "
               "AND s_region = 'ASIA' GROUP BY d_year",
    "ix_map": f"SELECT s_region, COUNT(*), SUM(lo_revenue) FROM {EVENTS_TABLE} "
              f"WHERE mapValue(props, 'clicks') > {MAP_CLICKS} "
              "GROUP BY s_region",
    "ix_vec": VEC_QUERY})
# the index queries that launch kernel A, once each (a family of 4)
INDEX_KERNEL_QUERIES = ("st_q2", "st_q9", "st_avg") + INDEX_QUERIES
EXPECTED_KERNEL.update({q: "limb_sums" for q in INDEX_KERNEL_QUERIES})
ONE_FAMILY += ST_QUERIES + INDEX_QUERIES
# phase `host_engine`: the host engine (engine/host_executor.py) and the
# backend selector. `clicks`, a clickstream after Pinot's funnel
# documentation (FUNNELCOUNT(STEPS(url = ...), CORRELATE_BY(user_id)) over
# an events table of user_id, url, timestamp), 4 segments of CLICKS_ROWS
# built from CLICKS_SEED in the index_data pool: user_id of CLICKS_USERS
# users, url one of 8 pages (skewed), ts a week of epoch millis (raw, a
# range index), s_region (an inverted index), lat / lng raw DOUBLEs over
# the continental US (a geo index), lo_revenue INT
CLICKS_TABLE, CLICKS_SEED, CLICKS_ROWS = "clicks", 2032, 1 << 21
CLICKS_USERS = 1 << 17
CLICKS_PAGES = ("/home", "/search", "/product", "/cart", "/checkout", "/pay",
                "/done", "/help")
CLICKS_PAGE_P = (0.24, 0.2, 0.18, 0.12, 0.08, 0.07, 0.06, 0.05)
CLICKS_T0, CLICKS_SPAN = 1_700_006_400_000, 7 * DAY_MS
CLICKS_DIMS = [("user_id", "INT"), ("url", "STRING"), ("s_region", "STRING")]
CLICKS_METRICS = [("ts", "LONG"), ("lat", "DOUBLE"), ("lng", "DOUBLE"),
                  ("lo_revenue", "INT")]
CLICKS_INDEXING = {
    "no_dictionary_columns": ["ts", "lat", "lng", "lo_revenue"],
    "inverted_index_columns": ["s_region"], "range_index_columns": ["ts"],
    "geo_index_configs": [{"latColumn": "lat", "lngColumn": "lng",
                           "resolutionDeg": 0.5}]}
FUNNEL_STEPS = ("/product", "/cart", "/pay")
MAXSTEP_STEPS, MAXSTEP_WINDOW_MS = ("/search", "/product", "/cart",
                                    "/pay"), 60_000
CLICKS_RANGE = (CLICKS_T0 + 2 * DAY_MS, CLICKS_T0 + 3 * DAY_MS)
GEO_CENTRE, GEO_RADIUS_M = (40.7128, -74.006), 400_000.0
EARTH_RADIUS_M = 6371008.8
CLICKS_QUERIES = {
    "c_funnel": "SELECT s_region, FUNNELCOUNT(STEPS("
                + ", ".join(f"url = '{u}'" for u in FUNNEL_STEPS)
                + f"), CORRELATE_BY(user_id)) FROM {CLICKS_TABLE} "
                "GROUP BY s_region ORDER BY s_region",
    "c_maxstep": f"SELECT s_region, FUNNELMAXSTEP(ts, {MAXSTEP_WINDOW_MS}, "
                 f"{len(MAXSTEP_STEPS)}, "
                 + ", ".join(f"url = '{u}'" for u in MAXSTEP_STEPS)
                 + f") FROM {CLICKS_TABLE} GROUP BY s_region "
                 "ORDER BY s_region",
    "c_eq": f"SELECT url, COUNT(*), SUM(lo_revenue) FROM {CLICKS_TABLE} "
            "WHERE s_region = 'ASIA' GROUP BY url ORDER BY url",
    "c_in": f"SELECT s_region, COUNT(*), SUM(lo_revenue) FROM {CLICKS_TABLE} "
            "WHERE s_region IN ('ASIA', 'EUROPE') GROUP BY s_region "
            "ORDER BY s_region",
    "c_range": f"SELECT url, COUNT(*), SUM(lo_revenue) FROM {CLICKS_TABLE} "
               f"WHERE ts BETWEEN {CLICKS_RANGE[0]} AND {CLICKS_RANGE[1]} "
               "GROUP BY url ORDER BY url",
    "c_geo": f"SELECT url, COUNT(*), SUM(lo_revenue) FROM {CLICKS_TABLE} "
             f"WHERE ST_DISTANCE(lat, lng, {GEO_CENTRE[0]}, {GEO_CENTRE[1]})"
             f" < {GEO_RADIUS_M} GROUP BY url ORDER BY url"}
# under backend "auto": the clicks queries the device planner plans (one
# family dispatch, one launch of kernel A each); the funnels and the
# ST_DISTANCE filter answer on the host engine
CLICKS_DEVICE = ("c_eq", "c_in", "c_range")
# ssb_rt with its consuming snapshot refused (the query option that keeps
# a consuming segment off the device) while the 4 committed segments plan:
# one family launch of kernel A, the snapshot on the host engine
RT_AUTO_SQL = "SET realtimeDevicePlanes = false; " + Q2.replace(
    "FROM ssb", "FROM ssb_rt")
HOST_SSB_QUERIES = ("q1", "q2_family")
# the PurgeTask over a raw STRING column: PURGE_ROWS of the clicks columns
# (url raw), the rows whose url matches PURGE_FILTER purged
PURGE_TABLE, PURGE_ROWS, PURGE_FILTER = "clicks_log", 1 << 16, \
    "url LIKE '/c%' OR url = '/help'"
# the multi-stage engine over ssb: bench.py Q8, Q9J and Q10 verbatim (a
# JOIN sends them there), a pair join that returns rows, and bench.py Q2
# under SET useMultistageEngine = true (a leaf partial aggregate)
MSE = "SET useMultistageEngine = true; "
MSE_QUERIES = {
    "q8": "SELECT a.d_year, COUNT(*), SUM(b.lo_revenue) FROM ssb a "
          "JOIN ssb b ON a.lo_orderkey = b.lo_orderkey "
          "WHERE a.lo_quantity < 3 AND b.lo_discount = 0 "
          "GROUP BY a.d_year ORDER BY a.d_year LIMIT 100",
    "q9j": "SELECT a.d_year, COUNT(*), SUM(b.lo_revenue) FROM ssb a "
           "LEFT JOIN ssb b ON a.lo_orderkey = b.lo_orderkey "
           "AND b.lo_discount = 0 WHERE a.lo_quantity < 3 "
           "GROUP BY a.d_year ORDER BY a.d_year LIMIT 100",
    "q10": "SELECT a.d_year, COUNT(*), SUM(c.lo_revenue) FROM ssb a "
           "JOIN ssb b ON a.lo_orderkey = b.lo_orderkey "
           "JOIN ssb c ON b.lo_orderkey = c.lo_orderkey "
           "WHERE a.lo_quantity < 3 AND b.lo_discount = 0 "
           "AND c.lo_quantity < 2 "
           "GROUP BY a.d_year ORDER BY a.d_year LIMIT 100",
    "mse_pairs": MSE + "SELECT a.lo_orderkey, a.d_year, b.lo_revenue "
                 "FROM ssb a JOIN ssb b ON a.lo_orderkey = b.lo_orderkey "
                 "WHERE a.lo_quantity < 5 AND b.lo_discount <= 1 "
                 "ORDER BY b.lo_revenue DESC, a.lo_orderkey, a.d_year "
                 "LIMIT 1000",
    "mse_agg": MSE + Q2}
# phase `mse_cluster`: q8, q10 and mse_agg through the broker's cluster
# MSE, mse_agg again with one dispatch a segment (kernel B), and q8 across
# two OS processes (`ssb_l` on an in-process server, `ssb_r` on a child)
MSE_CLUSTER_QUERIES = {
    "q8": MSE_QUERIES["q8"], "q10": MSE_QUERIES["q10"],
    "mse_agg": MSE_QUERIES["mse_agg"],
    "mse_agg_solo": NO_BATCH + MSE_QUERIES["mse_agg"],
    "q8_two_process": MSE_QUERIES["q8"].replace(
        "FROM ssb a JOIN ssb b", "FROM ssb_l a JOIN ssb_r b")}
# the statements whose aggregate-over-join stage runs fused on the card, one
# host crossing each (q10's middle join absorbed into it)
FUSED_MSE = ("q8", "q9j", "q10")
# the deployment's maxRowsInJoin (PINOT_TPU_MAX_ROWS_IN_JOIN; the
# reference's default is 5,000,000): the guard counts a join's key matches
# before its ON residual, and q9j's LEFT join matches its 1.34M a rows
# with all 2^25 b rows' keys, about 10.7M pairs, of which its residual
# (lo_discount = 0) keeps about 1M
MAX_ROWS_IN_JOIN = 1 << 24
# q6, q6m and q6_sort are held by the host decode (PERF.md §5): they run
# in `queries` (rows, dispatches, launches), and leave `times`, `layers`
# and `profile`
HOST_HELD = ("q6", "q6m", "q6_sort")
# a query slower than this takes 1 warm run in `times`, `layers` and
# `profile`
SLOW_QUERY_MS = 1000.0
# warm runs a query in `layers` (at most --iters): cut from 10 to 5 to fit
# phase `mse_cluster` in the run's time limit, then to 3 (and --iters from
# 10 to 5) to fit phase `batch_ingest`, then to 2 (and --iters to 3) to fit
# phase `timeseries`, F13's statement and the minion; `times` keeps --iters
LAYERS_ITERS = 2


_LAST_PHASE = [time.perf_counter()]


def emit(obj) -> None:
    """Print one JSON line; a phase line gains `seconds`, the host time
    since the previous phase line (its own, where it sets one)."""
    now = time.perf_counter()
    if "phase" in obj:
        obj = dict(obj)
        obj.setdefault("seconds", now - _LAST_PHASE[0])
        _LAST_PHASE[0] = now
    print(json.dumps(obj), flush=True)


def gen_ssb(rows: int, seed: int) -> dict:
    """The SSB-shaped columns of the JAX package's benchmark (bench.py
    `_gen_ssb`), drawn in the same order from the same generator."""
    rng = np.random.default_rng(seed)
    return {
        "d_year": rng.integers(1992, 1999, rows).astype(np.int32),
        "p_brand": (rng.integers(0, 1000, rows)).astype(np.int32),
        "s_region": np.asarray(REGIONS, dtype=object)[rng.integers(0, 5, rows)],
        "lo_discount": rng.integers(0, 11, rows).astype(np.int32),
        "lo_quantity": rng.integers(1, 51, rows).astype(np.int32),
        "lo_extendedprice": rng.integers(1, 55_001, rows).astype(np.int32),
        "lo_revenue": rng.integers(1, 600_000, rows).astype(np.int32),
        # high-card key sorted in ingestion order, as SSB lineorder arrives
        "lo_orderkey": np.sort(
            rng.integers(0, max(1 << 22, rows // 10), rows)).astype(np.int32),
    }


def gen_tags(rows: int, seed: int):
    """The lo_tags column of `mvt`: 1 to 4 values a row, each one of
    MV_CARD, drawn from --seed + 1; (flat values, lengths)."""
    rng = np.random.default_rng(seed + 1)
    lens = rng.integers(1, MV_MAX + 1, rows)
    return rng.integers(0, MV_CARD, int(lens.sum())).astype(np.int32), lens


def gen_dates(d_year: np.ndarray, seed: int):
    """`ssbt`'s lo_orderdate (epoch millis of a uniform day of the row's
    d_year) and lo_commit_ts (lo_orderdate plus a uniform [0, 90 days) in
    millis), drawn from seed + 2."""
    rng = np.random.default_rng(seed + 2)
    first = np.asarray([f"{y}-01-01" for y in range(1992, 2000)],
                       dtype="datetime64[D]").astype(np.int64)
    k = d_year.astype(np.int64) - 1992
    day = first[k] + (rng.random(len(k)) * np.diff(first)[k]).astype(np.int64)
    order = day * DAY_MS
    return order, order + rng.integers(0, 90 * DAY_MS, len(k))


def gen_brands() -> dict:
    """bench.py's brands dimension table (`_register_brands_dim`)."""
    ids = np.arange(N_BRANDS, dtype=np.int32)
    return {"b_id": ids,
            "b_category": np.asarray([f"MFGR#{i % BRAND_CATEGORIES}"
                                      for i in ids], dtype=object),
            "b_region": np.asarray([REGIONS[i % len(REGIONS)] for i in ids],
                                   dtype=object)}


def gen_taxi(rows: int) -> dict:
    """bench.py's taxi table: the columns drawn in its order from its
    generator (seed 7); fare is kept raw."""
    rng = np.random.default_rng(7)
    return {
        "pickup_day": rng.integers(0, 730, rows).astype(np.int32),
        "passenger_count": rng.integers(1, 9, rows).astype(np.int32),
        "fare": np.round(rng.gamma(3.0, 9.0, rows), 2),
    }


# -- oracle -------------------------------------------------------------------


class Approx:
    """An oracle cell held to a relative tolerance: the approximate
    percentiles (2%, bench.py's bar for Q5) and the moment functions'
    float64 sums added in another order (1e-9)."""

    def __init__(self, value: float, rel: float):
        self.value, self.rel = float(value), rel

    def __eq__(self, other):
        return abs(float(other) - self.value) <= self.rel * max(
            1.0, abs(self.value))

    def __repr__(self):
        return f"Approx({self.value!r}, rel={self.rel})"


def _pct_exact(sorted_vals: np.ndarray, pct: float) -> float:
    """The reference PERCENTILE: element floor(n pct / 100) of the sorted
    values, clamped (the JAX package's tests pin it)."""
    n = len(sorted_vals)
    return float(sorted_vals[min(int(n * pct / 100.0), n - 1)])


def _distinct_per_run(run_of_row: np.ndarray, ids: np.ndarray, card: int,
                      runs: int) -> np.ndarray:
    """Distinct ids (in [0, card)) per run, for rows labelled 0..runs-1."""
    pairs = np.unique(run_of_row.astype(np.int64) * card + ids)
    return np.bincount(pairs // card, minlength=runs)


def matrix_oracle(cols: dict, hll) -> dict:
    """aggmix, q6, q6m and q6_sort over the ssb columns: the exact
    functions by their reference semantics, DISTINCTCOUNTHLL as the port's
    own HyperLogLog class fed with each group's exact distinct values (the
    device state is built from the same value set), PERCENTILETDIGEST
    within 2% of numpy's exact quantile, the moments to rtol 1e-9."""
    out = {}
    year = cols["d_year"].astype(np.int64)
    asia = cols["s_region"] == "ASIA"
    rows = []
    for y in range(1992, 1999):
        m = asia & (year == y)
        brands = np.unique(cols["p_brand"][m])
        disc = np.sort(cols["lo_discount"][m])
        qty = cols["lo_quantity"][m].astype(np.float64)
        rev = cols["lo_revenue"][m].astype(np.float64)
        price = cols["lo_extendedprice"][m].astype(np.float64)
        counts = np.bincount(disc)
        hist, _ = np.histogram(qty[(qty >= 0) & (qty <= 50)], bins=10,
                               range=(0, 50))
        rows.append([y, len(brands),
                     hll(12).add_values(brands).cardinality(),
                     _pct_exact(disc, 90), float(np.argmax(counts)),
                     [float(c) for c in hist],
                     Approx(np.quantile(rev, 0.95), 0.02),
                     Approx(np.std(price), 1e-9),
                     Approx(np.corrcoef(qty, rev)[0, 1], 1e-9)])
    out["aggmix"] = rows

    # q6 / q6m: the 100000 smallest lo_orderkey (the column is sorted)
    okey = cols["lo_orderkey"].astype(np.int64)
    disc = cols["lo_discount"].astype(np.int64)
    rev = cols["lo_revenue"].astype(np.int64)
    first = np.flatnonzero(np.r_[True, okey[1:] != okey[:-1]])
    end = first[100_000] if len(first) > 100_000 else len(okey)
    first = first[:100_000]
    run = np.repeat(np.arange(len(first)), np.diff(np.r_[first, end]))
    dc = _distinct_per_run(run, disc[:end], 11, len(first))
    rsum = np.bincount(run, weights=rev[:end].astype(np.float64),
                       minlength=len(first))
    out["q6"] = out["q6m"] = [[int(okey[a]), int(d), float(r)]
                              for a, d, r in zip(first, dc, rsum)]

    # q6_sort: the 100000 smallest (d_year, lo_orderkey) groups
    comp = (year << 32) | okey
    order = np.argsort(comp, kind="stable")
    sc = comp[order]
    first = np.flatnonzero(np.r_[True, sc[1:] != sc[:-1]])
    end = first[100_000] if len(first) > 100_000 else len(sc)
    first = first[:100_000]
    run = np.repeat(np.arange(len(first)), np.diff(np.r_[first, end]))
    dc = _distinct_per_run(run, disc[order[:end]], 11, len(first))
    out["q6_sort"] = [[int(sc[a] >> 32), int(sc[a] & 0xFFFFFFFF), int(d)]
                      for a, d in zip(first, dc)]
    return out


def taxi_oracle(cols: dict) -> dict:
    """q5 and q5_total over the taxi columns: DISTINCTCOUNT exact,
    HISTOGRAM by numpy's histogram of the values in [lo, hi], the
    PERCENTILETDIGEST cells within 2% of numpy's exact quantile."""
    day = cols["pickup_day"].astype(np.int64)
    fare = cols["fare"]
    order = np.argsort(day * (1 << 24) + np.round(fare * 100).astype(np.int64))
    sday, sfare = day[order], fare[order]
    edges = np.searchsorted(sday, np.arange(731))
    pairs = np.unique(day * 16 + cols["passenger_count"])
    dc = np.bincount(pairs // 16, minlength=730)
    q5 = [[d, int(dc[d]),
           Approx(np.quantile(sfare[edges[d]:edges[d + 1]], 0.95), 0.02)]
          for d in range(730) if edges[d + 1] > edges[d]]
    hist, _ = np.histogram(fare[(fare >= 0) & (fare <= 100)], bins=20,
                           range=(0, 100))
    total = [[len(np.unique(cols["passenger_count"])),
              Approx(np.quantile(fare, 0.5), 0.02), [float(c) for c in hist]]]
    return {"q5": q5, "q5_total": total}



def selection_mv_oracle(cols: dict, tags, per: int) -> dict:
    """The selections, the pruned queries and the MV queries, from the
    generated columns with numpy alone: rows in row (= segment) order;
    the MV columns as (doc, value) pairs, duplicates included."""
    out = {}
    okey = cols["lo_orderkey"].astype(np.int64)
    rev = cols["lo_revenue"].astype(np.int64)
    year = cols["d_year"].astype(np.int64)
    qty = cols["lo_quantity"]
    asia = cols["s_region"] == "ASIA"
    hit = np.flatnonzero(asia & (qty < 25))[:1000]
    out["sel_limit"] = [[int(okey[i]), int(year[i]), int(rev[i])] for i in hit]
    m = np.flatnonzero((year == 1993) & (qty < 3))
    top = m[np.lexsort((okey[m], -rev[m]))][:100]
    out["sel_order"] = [[int(okey[i]), int(rev[i])] for i in top]
    m = np.flatnonzero((okey >= 1500000) & (okey <= 1500999))[:1000]
    if not (len(m) and per <= m[0] and m[-1] < 2 * per
            and okey[per - 1] < 1500000 < 1500999 < okey[2 * per]):
        raise AssertionError("sel_pruned's key range is not inside segment 1")
    out["sel_pruned"] = [[int(okey[i]), int(rev[i])] for i in m]
    out["agg_all_pruned"] = [[0, []]]

    flat, lens = tags
    doc = np.repeat(np.arange(len(lens)), lens)
    hit = np.zeros(len(lens), dtype=bool)
    hit[doc[np.isin(flat, MV_TAGS)]] = True
    out["mv_filter"] = [
        [y, int((hit & (year == y)).sum()),
         float(rev[hit & (year == y)].sum())]
        for y in range(1992, 1999) if (hit & (year == y)).any()]
    pair = asia[doc]
    cnt = np.bincount(flat[pair], minlength=MV_CARD)
    psum = np.bincount(flat[pair], weights=rev[doc[pair]].astype(np.float64),
                       minlength=MV_CARD)
    out["mv_group"] = [[int(t), int(cnt[t]), float(psum[t])]
                       for t in np.nonzero(cnt)[0]]
    rows = []
    year_of_value = year[doc]
    for y in range(1992, 1999):
        v = flat[year_of_value == y].astype(np.int64)
        lo, hi = float(v.min()), float(v.max())
        rows.append([y, len(v), float(v.sum()), lo, hi, float(v.sum()) / len(v),
                     hi - lo])
    out["mv_aggs"] = rows
    return out


def transform_oracle(cols: dict, dates) -> dict:
    """q7, time_group, str_group, time_raw and post_agg with numpy alone:
    the calendar through numpy's datetime64, the group sums by bincount
    with float64 weights (exact below 2^53)."""
    year = cols["d_year"].astype(np.int64)
    brand = cols["p_brand"].astype(np.int64)
    rev = cols["lo_revenue"].astype(np.float64)
    out = {}
    asia_brand = (brand % len(REGIONS)) == REGIONS.index("ASIA")
    key = (year - 1992) * BRAND_CATEGORIES + brand % BRAND_CATEGORIES
    sums = np.bincount(key[asia_brand], weights=rev[asia_brand],
                       minlength=7 * BRAND_CATEGORIES)
    cnt = np.bincount(key[asia_brand], minlength=7 * BRAND_CATEGORIES)
    out["q7"] = [[int(1992 + k // BRAND_CATEGORIES),
                  f"MFGR#{k % BRAND_CATEGORIES}", float(sums[k])]
                 for k in np.nonzero(cnt)[0]]

    order, commit = dates
    month = (order // DAY_MS).astype("datetime64[D]").astype("datetime64[M]")
    mkey = month.astype(np.int64)  # months since 1970-01
    m0 = int(mkey.min())
    asia = cols["s_region"] == "ASIA"
    cnt = np.bincount(mkey[asia] - m0)
    sums = np.bincount(mkey[asia] - m0, weights=rev[asia])
    first_ms = (np.arange(len(cnt)) + m0).astype("datetime64[M]") \
        .astype("datetime64[D]").astype(np.int64) * DAY_MS
    out["time_group"] = [[float(first_ms[k]), int(cnt[k]), float(sums[k])]
                         for k in np.nonzero(cnt)[0]]
    regions = [r for r in REGIONS if r.startswith("A")]
    rows = []
    for r in regions:
        m = cols["s_region"] == r
        c = np.bincount(mkey[m] - m0, minlength=len(first_ms))
        sm = np.bincount(mkey[m] - m0, weights=rev[m], minlength=len(first_ms))
        rows += [[str(np.datetime64(int(k) + m0, "M")), r.lower(), int(c[k]),
                  float(sm[k])] for k in np.nonzero(c)[0]]
    out["str_group"] = rows

    cmonth = (commit // DAY_MS).astype("datetime64[D]") \
        .astype("datetime64[M]").astype(np.int64) % 12 + 1
    dec = cmonth == 12
    lag = (commit // DAY_MS - order // DAY_MS).astype(np.float64)
    cnt = np.bincount(year[dec] - 1992, minlength=7)
    sums = np.bincount(year[dec] - 1992, weights=lag[dec], minlength=7)
    out["time_raw"] = [[int(1992 + k), int(cnt[k]), float(sums[k])]
                       for k in np.nonzero(cnt)[0]]

    cnt = np.bincount(year - 1992, minlength=7)
    sums = np.bincount(year - 1992, weights=rev, minlength=7)
    out["post_agg"] = [[1992 + k, float(np.floor(
        float(sums[k]) / int(cnt[k]) * 10.0 + 0.5) / 10.0)] for k in range(7)]
    return out


def f13_oracle(cols: dict) -> list:
    """F13_SQL's rows: per region the value at index floor(n * 0.9) of its
    sorted lo_revenue (the reference's PERCENTILE)."""
    out = []
    for r in sorted(REGIONS):
        v = cols["lo_revenue"][cols["s_region"] == r]
        k = min(int(len(v) * 90 / 100.0), len(v) - 1)
        out.append([r, float(np.partition(v, k)[k])])
    return out


def timeseries_oracle(cols: dict, dates) -> dict:
    """Each TS_QUERIES block's to_json() with numpy alone: the fetch's
    per-(bucket, tag) SUM / MAX / COUNT by bincount and maximum.at (sums
    of integers below 2^53: exact), then the pipe stages by the reference
    engine's formulas (timeseries/engine.py): a tag aggregation over one
    series a tag is the identity, moving_avg the mean of the window's
    non-NaN values, topk by the series' nansum, transform_null a fill."""
    order = dates[0]
    region = np.zeros(len(order), dtype=np.int64)
    for i, r in enumerate(REGIONS):
        region[cols["s_region"] == r] = i
    names = sorted(REGIONS)
    rank = np.asarray([names.index(r) for r in REGIONS])[region]
    rev = cols["lo_revenue"].astype(np.float64)

    def fetch(mask, agg, tags, start, end, step):
        nb = max(1, -(-(end - start) // step))
        idx = (order - order % step - start) // step
        keep = mask & (order >= start) & (order <= end) & (idx >= 0) \
            & (idx < nb)
        nk = len(names) if tags else 1
        flat = idx[keep] * nk + (rank[keep] if tags else 0)
        cnt = np.bincount(flat, minlength=nb * nk)
        if agg == "sum":
            val = np.bincount(flat, weights=rev[keep], minlength=nb * nk)
        elif agg == "max":
            val = np.full(nb * nk, -np.inf)
            np.maximum.at(val, flat, rev[keep])
        else:
            val = cnt.astype(np.float64)
        val = np.where(cnt > 0, val, np.nan).reshape(nb, nk).T
        series = [({"s_region": names[k]} if tags else {}, val[k])
                  for k in range(nk) if cnt.reshape(nb, nk)[:, k].any()]
        return nb, series

    def moving_avg(v, w):
        out = np.full_like(v, np.nan)
        for i in range(len(v)):
            win = v[max(0, i - w + 1):i + 1]
            win = win[~np.isnan(win)]
            if len(win):
                out[i] = win.sum() / len(win)
        return out

    def block(start, step, nb, series):
        return {"timeBuckets": {"start": start, "step": step,
                                "numBuckets": nb},
                "series": [{"tags": t, "values": [
                    None if np.isnan(x) else float(x) for x in v]}
                    for t, v in series]}

    out = {}
    _, start, end, step = TS_QUERIES["ts_weekly"]
    nb, series = fetch(cols["lo_quantity"] < 25, "sum", True, start, end,
                       step)
    series = [(t, moving_avg(v, 4)) for t, v in series]
    series = sorted(series, key=lambda s: np.nansum(s[1]), reverse=True)[:3]
    out["ts_weekly"] = block(start, step, nb, series)
    _, start, end, step = TS_QUERIES["ts_daily_max"]
    out["ts_daily_max"] = block(start, step, *fetch(
        np.ones(len(order), dtype=bool), "max", True, start, end, step))
    _, start, end, step = TS_QUERIES["ts_count"]
    nb, series = fetch(cols["lo_discount"] < 2, "count", False, start, end,
                       step)
    out["ts_count"] = block(start, step, nb, [
        (t, np.where(np.isnan(v), 0.0, v)) for t, v in series])
    return out


def q2_oracle(cols: dict, region: str = "ASIA") -> list:
    """bench.py Q2's rows over `cols`, with s_region = `region`."""
    year = cols["d_year"].astype(np.int64)
    brand = cols["p_brand"].astype(np.int64)
    m = cols["s_region"] == region
    key = ((year - 1992) * 1000 + brand)[m]
    sums = np.bincount(key, weights=cols["lo_revenue"][m].astype(
        np.float64), minlength=7000)
    return [[int(1992 + k // 1000), int(k % 1000), float(sums[k])]
            for k in np.nonzero(np.bincount(key, minlength=7000))[0]]


def oracle(cols: dict) -> dict:
    """Expected result rows of every query, from the generated columns with
    numpy alone. Group sums come from np.bincount with float64 weights:
    every partial sum is an integer below 2^53, so they are exact."""
    year, brand = cols["d_year"].astype(np.int64), cols["p_brand"].astype(np.int64)
    rev = cols["lo_revenue"].astype(np.int64)
    price = cols["lo_extendedprice"].astype(np.int64)
    qty = cols["lo_quantity"].astype(np.int64)
    out = {}
    m1 = ((year == 1993) & (cols["lo_discount"] >= 1) & (cols["lo_discount"] <= 3)
          & (qty < 25))
    out["q1"] = [[float(price[m1].sum())]]

    asia = cols["s_region"] == "ASIA"
    key = ((year - 1992) * 1000 + brand)[asia]
    cnt = np.bincount(key, minlength=7000)
    sums = [np.bincount(key, weights=v[asia].astype(np.float64), minlength=7000)
            for v in (rev, price, qty)]
    occ = np.nonzero(cnt)[0]
    out["q2"] = [[int(1992 + k // 1000), int(k % 1000), float(sums[0][k])]
                 for k in occ]
    for region in REGIONS:  # phase coalesce's mixed literals
        out[f"q2/{region}"] = q2_oracle(cols, region)
    out["q2_unfused"] = out["q2"]
    out["q9"] = [[int(1992 + k // 1000), int(k % 1000), float(sums[0][k]),
                  float(sums[1][k]), float(sums[2][k])] for k in occ]

    mf = year >= 1995
    b, r = brand[mf], rev[mf]
    fcnt = np.bincount(b, minlength=1000)
    fsum = np.bincount(b, weights=r.astype(np.float64), minlength=1000)
    fmin = np.full(1000, np.iinfo(np.int64).max)
    fmax = np.full(1000, np.iinfo(np.int64).min)
    np.minimum.at(fmin, b, r)
    np.maximum.at(fmax, b, r)
    out["flagship"] = [[int(k), float(fsum[k]), int(fcnt[k]), float(fmin[k]),
                        float(fmax[k])] for k in np.nonzero(fcnt)[0]]
    out["q2_family"] = out["q4"] = out["q2"]
    out["flagship_family"] = out["flagship"]

    def runs(sorted_keys, limit=100_000):
        """First row and row count of each run of equal keys, the first
        `limit` runs."""
        first = np.flatnonzero(np.r_[True, sorted_keys[1:] != sorted_keys[:-1]])
        return first[:limit], np.diff(np.r_[first, len(sorted_keys)])[:limit]

    # q3 / q3m: the 100000 smallest lo_orderkey (the column is sorted)
    okey = cols["lo_orderkey"].astype(np.int64)
    first, count = runs(okey)
    rsum = np.add.reduceat(rev, first) if len(first) else []
    rsum[-1:] = rev[first[-1]:first[-1] + count[-1]].sum() if len(first) else []
    out["q3"] = out["q3m"] = [[int(okey[a]), float(s), int(c)]
                              for a, s, c in zip(first, rsum, count)]

    # q3_sort: the 100000 smallest (d_year, lo_orderkey) groups
    comp = (year << 32) | okey
    order = np.argsort(comp, kind="stable")
    sc, sr = comp[order], rev[order]
    first, count = runs(sc)
    seg = [(np.add, "sum"), (np.minimum, "min"), (np.maximum, "max")]
    red = {name: fn.reduceat(sr, first) for fn, name in seg}
    for fn, name in seg:  # the last run ends at its own count
        red[name][-1] = getattr(sr[first[-1]:first[-1] + count[-1]], name)()
    out["q3_sort"] = [
        [int(sc[a] >> 32), int(sc[a] & 0xFFFFFFFF), float(s), int(c),
         float(lo), float(hi)]
        for a, s, c, lo, hi in zip(first, red["sum"], count, red["min"],
                                   red["max"])]

    # sparse_family: every brand, no filter
    acnt = np.bincount(brand, minlength=1000)
    asum = np.bincount(brand, weights=rev.astype(np.float64), minlength=1000)
    amin = np.full(1000, np.iinfo(np.int64).max)
    amax = np.full(1000, np.iinfo(np.int64).min)
    np.minimum.at(amin, brand, rev)
    np.maximum.at(amax, brand, rev)
    out["sparse_family"] = [[int(k), float(asum[k]), int(acnt[k]),
                             float(amin[k]), float(amax[k])]
                            for k in np.nonzero(acnt)[0]]
    out["q4_solo"] = out["q4"]
    out["sparse_family_solo"] = out["sparse_family"]
    return out


def mse_oracle(cols: dict) -> dict:
    """Expected rows of the multi-stage statements from the generated
    columns. Per join key k, cb[k] and sb[k] count and sum the b rows
    (lo_discount = 0): an a row (lo_quantity < 3) of key k makes cb[k]
    pairs summing sb[k] in q8; max(cb[k], 1) rows in q9j (its LEFT join
    keeps an unmatched a row); cb[k] * cc[k] pairs summing cb[k] * sc[k]
    in q10, c the rows of lo_quantity < 2. Sums are float64 of integers
    below 2^53: exact. mse_pairs joins its filtered rows with numpy and
    sorts them as the statement does; mse_agg is q2."""
    key = cols["lo_orderkey"].astype(np.int64)
    year = cols["d_year"].astype(np.int64)
    rev = cols["lo_revenue"].astype(np.int64)
    qty, disc = cols["lo_quantity"], cols["lo_discount"]
    K = int(key.max()) + 1

    def per_key(m):
        return (np.bincount(key[m], minlength=K),
                np.bincount(key[m], weights=rev[m].astype(np.float64),
                            minlength=K))

    cb, sb = per_key(disc == 0)
    cc, sc = per_key(qty < 2)
    a = qty < 3
    ka, ya = key[a], year[a] - 1992

    def by_year(w):
        return np.bincount(ya, weights=w.astype(np.float64), minlength=7)

    out = {}
    for qname, cnt, tot in (
            ("q8", cb[ka], sb[ka]),
            ("q10", cb[ka] * cc[ka], cb[ka] * sc[ka])):
        c, t = by_year(cnt), by_year(tot)
        out[qname] = [[1992 + y, int(c[y]), float(t[y])]
                      for y in range(7) if c[y] > 0]
    c, t, m = by_year(np.maximum(cb[ka], 1)), by_year(sb[ka]), by_year(cb[ka])
    out["q9j"] = [[1992 + y, int(c[y]), float(t[y]) if m[y] else None]
                  for y in range(7) if c[y] > 0]

    pa, pb = np.nonzero(qty < 5)[0], np.nonzero(disc <= 1)[0]
    pb = pb[np.argsort(key[pb], kind="stable")]
    starts = np.searchsorted(key[pb], key[pa], "left")
    counts = np.searchsorted(key[pb], key[pa], "right") - starts
    li = np.repeat(pa, counts)
    ri = pb[np.repeat(starts, counts) + np.arange(len(li)) - np.repeat(
        np.cumsum(counts) - counts, counts)]
    top = np.lexsort((year[li], key[li], -rev[ri]))[:1000]
    out["mse_pairs"] = [[int(key[li[i]]), int(year[li[i]]), int(rev[ri[i]])]
                        for i in top]
    out["mse_pairs_total"] = int(len(li))
    return out


def rt_partials(cols: dict) -> dict:
    """What the ssb_rt queries sum over a block of ssb rows: q1's sum, q2's
    ASIA counts and sums by (d_year, p_brand), the RANGE's counts and sums
    by d_year. Blocks add up: the immutable rows' partials once, the
    consuming prefix's at each generation."""
    year = cols["d_year"].astype(np.int64) - 1992
    rev = cols["lo_revenue"].astype(np.float64)
    m1 = ((year == 1) & (cols["lo_discount"] >= 1)
          & (cols["lo_discount"] <= 3) & (cols["lo_quantity"] < 25))
    asia = cols["s_region"] == "ASIA"
    key = (year * 1000 + cols["p_brand"])[asia]
    rng = (year >= 1) & (year <= 3)
    return {"q1": float(cols["lo_extendedprice"][m1].astype(np.int64).sum()),
            "q2_cnt": np.bincount(key, minlength=7000),
            "q2_sum": np.bincount(key, weights=rev[asia], minlength=7000),
            "range_cnt": np.bincount(year[rng], minlength=7),
            "range_sum": np.bincount(year[rng], weights=rev[rng],
                                     minlength=7)}


def rt_expected(parts: list) -> dict:
    """The ssb_rt queries' rows over the rows of every partial."""
    tot = {k: sum(p[k] for p in parts) for k in parts[0]}
    occ = np.nonzero(tot["q2_cnt"])[0]
    return {"rt_q1": [[tot["q1"]]],
            "rt_q2": [[int(1992 + k // 1000), int(k % 1000),
                       float(tot["q2_sum"][k])] for k in occ],
            "rt_range": [[int(1992 + y), int(tot["range_cnt"][y]),
                          float(tot["range_sum"][y])]
                         for y in np.nonzero(tot["range_cnt"])[0]]}


def ups_expected(cols: dict, pk: np.ndarray, ts: np.ndarray) -> list:
    """The ups query's rows: the newest version of each key, newest by ts
    and then by arrival (the upsert manager's rule), ASIA by d_year."""
    order = np.lexsort((np.arange(len(pk)), ts, pk))
    last = order[np.r_[pk[order][1:] != pk[order][:-1], True]]
    keep = last[cols["s_region"][last] == "ASIA"]
    year = cols["d_year"][keep].astype(np.int64)
    cnt = np.bincount(year - 1992, minlength=7)
    rev = np.bincount(year - 1992, minlength=7,
                      weights=cols["lo_revenue"][keep].astype(np.float64))
    return [[int(1992 + y), float(rev[y]), int(cnt[y])]
            for y in np.nonzero(cnt)[0]]


# -- phases -------------------------------------------------------------------


def phase_device(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"{name}: compute capability {cap}, need (9, 0)")
    smi = shutil.which("nvidia-smi")
    power = "not measured (nvidia-smi not found)"
    if smi:
        power = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    info = {"phase": "device", "name": name, "capability": list(cap),
            "count": torch.cuda.device_count(), "nvidia_smi": power,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build(_cuda) -> None:
    """nvcc builds the kernels; g++ builds the native host library beside
    them, before any process of the spawn pool needs it."""
    from pinot_tpu_torch.segment import native_bridge

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as host:
        native = host.submit(native_bridge.get_lib)
        _cuda.library()
        native.result()
    lines = [ln.strip() for ln in _cuda.build_log().splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln
             or ln.startswith("==")]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": lines,
          "native_library": native_bridge.library_path().name})


def limb_inputs(torch, n, P, G, seed, masked_frac=0.8):
    """Kernel A inputs shaped like the dense path's: ~masked_frac of the
    rows are filtered out, so they carry the trash gid and zero payloads."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    gid = torch.randint(0, max(1, G - 1), (n,), dtype=torch.int32,
                        device=DEVICE, generator=g)
    masked = torch.rand(n, device=DEVICE, generator=g) < masked_frac
    gid[masked] = G - 1
    planes = torch.randint(0, 128, (P, n), dtype=torch.int8, device=DEVICE,
                           generator=g)
    planes[:, masked] = 0
    return planes, gid


def check_equal(torch, name, got, ref) -> int:
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                             f"{ref.dtype}{tuple(ref.shape)}")
    err = int((got - ref).abs().max().item()) if got.numel() else 0
    if err != 0:
        raise AssertionError(f"{name}: max |kernel - plain| = {err}")
    return err


def synthetic_fused_cases(torch, fg, seed, n=(1 << 22) + 3):
    """Kernel B cases beyond the main path's plans: an interval term over
    a uint16 plane, a dict-id run term over a uint8 plane, a signed SUM
    (five limbs plus the negative-count plane), and 24 planes of 1001
    groups, at a ragged length."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def rnd(lo, hi, dtype):
        return torch.randint(lo, hi, (n,), dtype=torch.int64, device=DEVICE,
                             generator=g).to(dtype)

    u16, u8 = rnd(0, 2000, torch.uint16), rnd(0, 100, torch.uint8)
    pos, signed = rnd(0, 1 << 20, torch.int32), rnd(-(1 << 30), 1 << 30, torch.int32)
    sc = lambda *v: torch.tensor(v, dtype=torch.int32, device=DEVICE)  # noqa: E731
    sc_n = max(0, n - 5)
    limbs = lambda slot, bits: tuple(("limb", slot, s) for s in range(0, bits, 7))  # noqa: E731
    cases = {
        "interval": (fg.FusedPlan((("iv", 0, 0, 1, True, True),), ((1, 1),),
                                  (("count",),) + limbs(2, 20), (), (0, 1, 2)),
                     (u16, u8, pos), sc(sc_n, 0, 500, 1500), 101),
        "runs": (fg.FusedPlan((("runs", 1, 0, 3),), ((0, 1),),
                              (("count",),) + limbs(2, 20), (), (1, 0, 2)),
                 (u8, u16, pos), sc(n, 0, 2, 5, 9, 9, 20, 40), 2001),
        "signed_sum": (fg.FusedPlan((), ((0, 1),),
                                    (("count",),) + limbs(1, 32) + (("neg", 1),),
                                    (), (0, 1)),
                       (u16, signed), sc(n, 0), 2001),
        "P24_G1001": (fg.FusedPlan((), ((0, 1),),
                                   (("count",),) + limbs(1, 32) + limbs(2, 32)
                                   + limbs(3, 32) + limbs(4, 32)
                                   + (("neg", 1), ("neg", 4)) + limbs(2, 7),
                                   (), (0, 1, 2, 3, 4)),
                      (rnd(0, 1001, torch.uint16), signed, pos, u8.to(torch.int32),
                       signed.flip(0)), sc(n, 0), 1001),
    }
    return {k: (fp, planes, scal, G, n) for k, (fp, planes, scal, G) in cases.items()}


@contextlib.contextmanager
def recording(owner, name, tag=None, with_kwargs=False, timed=False):
    """Record the arguments of every call to owner.name (calls go through):
    its positional arguments, or (args, kwargs) with `with_kwargs`, each
    with tag()'s value at the call when a tag is given, or with the ms the
    call took (host clock) when `timed`."""
    calls = []
    orig = getattr(owner, name)

    def wrapper(*args, **kwargs):
        got = (args, kwargs) if with_kwargs else args
        if not timed:
            calls.append(got if tag is None else (got, tag()))
            return orig(*args, **kwargs)
        t0 = time.perf_counter()
        try:
            return orig(*args, **kwargs)
        finally:
            calls.append((got, (time.perf_counter() - t0) * 1e3))

    setattr(owner, name, wrapper)
    try:
        yield calls
    finally:
        setattr(owner, name, orig)


@contextlib.contextmanager
def dispatch_rows(ex):
    """While active, the yielded callable gives the row counts of the
    segments that the executor's dispatch in progress covers: one segment,
    or the members of a batch family."""
    cur = []
    solo, batch = ex.dispatch_plan, ex.dispatch_plan_batch

    def one(segment, plan):
        cur[:] = [segment.num_docs]
        return solo(segment, plan)

    def family(segments, plans, repeat=1):
        cur[:] = [s.num_docs for s in segments] * repeat
        return batch(segments, plans, repeat)

    ex.dispatch_plan, ex.dispatch_plan_batch = one, family
    try:
        yield lambda: list(cur)
    finally:
        del ex.dispatch_plan, ex.dispatch_plan_batch


def _data_table(name: str):
    """(schema, table config) of a table phase `data` builds."""
    from pinot_tpu_torch.spi.data_types import Schema
    from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

    raw = RAW_COLUMNS
    if name == MV_TABLE:
        schema = Schema.build(name, dimensions=SCHEMA_DIMS + [
            ("lo_tags", "INT", False)], metrics=SCHEMA_METRICS)
    elif name == TAXI_TABLE:
        schema = Schema.build(name, dimensions=[("pickup_day", "INT"),
                                                ("passenger_count", "INT")],
                              metrics=[("fare", "DOUBLE")])
        raw = ["fare"]
    elif name == TIME_TABLE:
        schema = Schema.build(name, dimensions=SCHEMA_DIMS + [
            ("lo_orderdate", "TIMESTAMP"), ("lo_commit_ts", "TIMESTAMP")],
            metrics=SCHEMA_METRICS)
        raw = RAW_COLUMNS + ["lo_commit_ts"]
    else:
        schema = Schema.build(name, dimensions=SCHEMA_DIMS,
                              metrics=SCHEMA_METRICS)
    return schema, TableConfig(table_name=name, indexing=IndexingConfig(
        no_dictionary_columns=raw))


def build_data_segment(task):
    """Build one segment of a phase `data` table (a worker of the spawn
    process pool): (table, seconds). An `lo_tags` column arrives as its
    (flat values, lengths)."""
    from pinot_tpu_torch.segment.builder import MultiValues, SegmentBuilder

    name, i, cols, path = task
    t0 = time.perf_counter()
    if "lo_tags" in cols:
        cols = dict(cols, lo_tags=MultiValues(*cols["lo_tags"]))
    schema, cfg = _data_table(name)
    SegmentBuilder(schema, cfg, f"{name}_{i}").build(cols, path)
    return name, time.perf_counter() - t0


def phase_data(args, torch, tmp: str, pool):
    """The generated rows, built once into --segments segments (table
    `ssb`), once more into FAMILY_SEGMENTS segments (table `ssb16`), with
    the lo_tags column into --segments segments (table `mvt`), and with
    lo_orderdate and lo_commit_ts (table `ssbt`); bench.py's taxi rows
    into --segments segments (table `taxi`), and the `brands` dimension
    table, under the build dir `tmp`, every segment built in the spawn
    process `pool`; returns {table: (schema, segments)}, the brands
    (schema, segments), the ssb columns, the two date columns, the tags
    and the taxi columns."""
    from pinot_tpu_torch.segment.builder import SegmentBuilder
    from pinot_tpu_torch.segment.loader import load_segment
    from pinot_tpu_torch.spi.data_types import Schema
    from pinot_tpu_torch.spi.table_config import TableConfig

    t0 = time.perf_counter()
    rows = args.rows_per_segment * args.segments
    cols = gen_ssb(rows, args.seed)
    t_gen = time.perf_counter() - t0
    tags = gen_tags(rows, args.seed)
    taxi = gen_taxi(rows)
    dates = gen_dates(cols["d_year"], args.seed)
    offsets = np.r_[0, np.cumsum(tags[1])]
    counts = {"ssb": args.segments, FAMILY_TABLE: FAMILY_SEGMENTS,
              MV_TABLE: args.segments, TAXI_TABLE: args.segments,
              TIME_TABLE: args.segments}
    futures = []
    for name, count in counts.items():
        per = rows // count
        for i in range(count):
            sl = slice(i * per, (i + 1) * per)
            part = {k: v[sl] for k, v in (
                taxi if name == TAXI_TABLE else cols).items()}
            if name == MV_TABLE:
                part["lo_tags"] = (
                    tags[0][offsets[i * per]:offsets[(i + 1) * per]],
                    tags[1][sl])
            elif name == TIME_TABLE:
                part["lo_orderdate"], part["lo_commit_ts"] = (
                    dates[0][sl], dates[1][sl])
            futures.append(pool.submit(build_data_segment, (
                name, i, part, f"{tmp}/{name}_{i}")))
    # each table's segment builds, summed over the workers that ran them
    build_s = {}
    for fut in futures:
        name, sec = fut.result()
        build_s[name] = build_s.get(name, 0.0) + sec
    tables = {name: (_data_table(name)[0],
                     [load_segment(f"{tmp}/{name}_{i}") for i in range(count)])
              for name, count in counts.items()}
    schema = Schema.build(DIM_TABLE, dimensions=[
        ("b_id", "INT"), ("b_category", "STRING"), ("b_region", "STRING")],
        primary_key_columns=["b_id"])
    d = f"{tmp}/{DIM_TABLE}"
    SegmentBuilder(schema, TableConfig(table_name=DIM_TABLE),
                   DIM_TABLE).build(gen_brands(), d)
    dim = (schema, [load_segment(d)])
    emit({"phase": "data", "rows": rows,
          "tables": {k: {"segments": len(s), "rows_per_segment": rows // len(s)}
                     for k, (_, s) in tables.items()},
          "seed": args.seed, "generate_s": t_gen, "build_s": build_s,
          "setup_s": time.perf_counter() - t0, "dir": tmp,
          "mv_values": int(tags[1].sum()),
          "mv_matrix_bytes": rows * MV_MAX * 4,
          "order_days": int(len(np.unique(dates[0]))),
          "dim_rows": N_BRANDS})
    return tables, dim, cols, dates, tags, taxi


# -- the index tables: star-tree, JSON, text, map and vector indexes ---------


def _events_columns(rng, n: int):
    """One events segment's indexed columns from rng, and the rows each
    index query must match, computed from the drawn values (not from the
    strings or the indexes): attrs JSON {"country", "device": {"os",
    "ver"}, "tags": 0 to 3 of 100}; msg, 8 to 16 Zipf-drawn words with the
    phrase "connection reset" put in one row in PHRASE_EVERY; props,
    {"clicks": 0..50, "dwell": float} without "clicks" in one row in
    MAP_ABSENT_EVERY."""
    country = rng.integers(0, N_COUNTRIES, n)
    os_id = rng.integers(0, len(OS_NAMES), n)
    ver = rng.integers(1, MAX_VER + 1, n)
    ntags = rng.integers(0, 4, n)
    tags = rng.integers(0, N_TAGS, int(ntags.sum()))
    toff = np.r_[0, np.cumsum(ntags)].tolist()
    tag_str = [f'"t{t}"' for t in tags.tolist()]
    attrs = [f'{{"country": "c{c}", "device": {{"os": "{OS_NAMES[o]}", '
             f'"ver": {v}}}, "tags": [{", ".join(tag_str[a:b])}]}}'
             for c, o, v, a, b in zip(country.tolist(), os_id.tolist(),
                                      ver.tolist(), toff[:-1], toff[1:])]
    tag_doc = np.repeat(np.arange(n), ntags)
    json_hit = (os_id == 0) & np.isin(
        np.arange(n), tag_doc[tags == JSON_TAG])
    words = np.asarray(TEXT_WORDS, dtype=object)
    lens = rng.integers(8, 17, n)
    off = np.r_[0, np.cumsum(lens)]
    ranks = (rng.zipf(TEXT_ZIPF, int(off[-1])) - 1) % len(TEXT_WORDS)
    phrase = np.flatnonzero(rng.random(n) < 1 / PHRASE_EVERY)
    at = off[phrase] + (rng.random(len(phrase)) * (lens[phrase] - 1)
                        ).astype(np.int64)
    ranks[at], ranks[at + 1] = PHRASE_RANKS
    toks = words[ranks].tolist()
    bounds = off.tolist()
    msg = [" ".join(toks[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
    tok_doc = np.repeat(np.arange(n), lens)
    pair = (ranks[:-1] == PHRASE_RANKS[0]) & (ranks[1:] == PHRASE_RANKS[1]) \
        & (tok_doc[:-1] == tok_doc[1:])
    text_hit = np.zeros(n, dtype=bool)
    text_hit[tok_doc[:-1][pair]] = True
    text_hit[tok_doc[np.isin(ranks, PREFIX_RANKS)]] = True
    clicks = rng.integers(0, 51, n)
    dwell = np.round(rng.random(n) * 600, 3)
    absent = rng.random(n) < 1 / MAP_ABSENT_EVERY
    props = [f'{{"dwell": {d!r}}}' if a else f'{{"clicks": {c}, "dwell": {d!r}}}'
             for c, d, a in zip(clicks.tolist(), dwell.tolist(),
                                absent.tolist())]
    map_hit = (clicks > MAP_CLICKS) & ~absent
    return ({"attrs": attrs, "msg": msg, "props": props},
            {"ix_json": json_hit, "ix_text": text_hit, "ix_map": map_hit})


def haversine_oracle(lat, lng, lat0, lng0):
    """Great-circle metres (the haversine formula), for the oracle."""
    p1, l1 = np.radians(lat), np.radians(lng)
    p2, l2 = np.radians(lat0), np.radians(lng0)
    a = np.sin((p2 - p1) / 2) ** 2 \
        + np.cos(p1) * np.cos(p2) * np.sin((l2 - l1) / 2) ** 2
    return 2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def clicks_columns(i: int, n: int) -> tuple:
    """Segment i of `clicks` from CLICKS_SEED: (columns, page codes, region
    codes)."""
    rng = np.random.default_rng([CLICKS_SEED, i])
    page = rng.choice(len(CLICKS_PAGES), n, p=CLICKS_PAGE_P)
    region = rng.integers(0, len(REGIONS), n)
    cols = {
        "user_id": rng.integers(0, CLICKS_USERS, n).astype(np.int32),
        "url": np.asarray(CLICKS_PAGES, dtype=object)[page],
        "s_region": np.asarray(REGIONS, dtype=object)[region],
        "ts": CLICKS_T0 + rng.integers(0, CLICKS_SPAN, n).astype(np.int64),
        "lat": rng.uniform(25.0, 49.0, n),
        "lng": rng.uniform(-124.0, -67.0, n),
        "lo_revenue": rng.integers(0, 10_000, n).astype(np.int32),
    }
    return cols, page, region


def clicks_partials(cols, page, region) -> dict:
    """One segment's share of every clicks query's oracle, from the drawn
    codes and values: per page or region the rows and revenue under each
    filter, per region and funnel step the users that reached it, and the
    windowed funnel's (ts, step, region) events."""
    rev = cols["lo_revenue"].astype(np.int64)
    npages, nreg = len(CLICKS_PAGES), len(REGIONS)

    def by(codes, m, k):
        return (np.bincount(codes[m], minlength=k),
                np.bincount(codes[m], weights=rev[m], minlength=k))

    asia, europe = REGIONS.index("ASIA"), REGIONS.index("EUROPE")
    ts = cols["ts"]
    d = haversine_oracle(cols["lat"], cols["lng"], *GEO_CENTRE)
    step_of = np.full(npages, -1)
    for k, u in enumerate(MAXSTEP_STEPS):
        step_of[CLICKS_PAGES.index(u)] = k
    ev = step_of[page] >= 0
    return {
        "c_eq": by(page, region == asia, npages),
        "c_in": by(region, (region == asia) | (region == europe), nreg),
        "c_range": by(page, (ts >= CLICKS_RANGE[0]) & (ts <= CLICKS_RANGE[1]),
                      npages),
        "c_geo": by(page, d < GEO_RADIUS_M, npages),
        "c_funnel": [[np.unique(cols["user_id"][
            (region == r) & (page == CLICKS_PAGES.index(u))])
            for u in FUNNEL_STEPS] for r in range(nreg)],
        "c_maxstep": (ts[ev], step_of[page[ev]].astype(np.int8),
                      region[ev].astype(np.int8)),
    }


def _max_step(ts, step, nsteps, window) -> int:
    """The longest step prefix inside one window from any step-0 event,
    by brute force over the (ts, step)-sorted events."""
    order = np.lexsort((step, ts))
    ts, step = ts[order].tolist(), step[order].tolist()
    best = 0
    for k in range(len(ts)):
        if step[k] != 0:
            continue
        got, j = 0, k
        while j < len(ts) and ts[j] < ts[k] + window:
            if step[j] == got:
                got += 1
                if got == nsteps:
                    return nsteps
            j += 1
        best = max(best, got)
    return best


def clicks_oracle(parts: list) -> dict:
    """Every clicks query's rows from the segments' partials."""
    out = {}
    for q, keys in (("c_eq", CLICKS_PAGES), ("c_in", REGIONS),
                    ("c_range", CLICKS_PAGES), ("c_geo", CLICKS_PAGES)):
        n = sum(p[q][0] for p in parts)
        v = sum(p[q][1] for p in parts)
        out[q] = sorted([keys[k], int(n[k]), float(v[k])]
                        for k in range(len(keys)) if n[k])
    rows = []
    for r, name in enumerate(REGIONS):
        sets = [np.unique(np.concatenate([p["c_funnel"][r][k]
                                          for p in parts]))
                for k in range(len(FUNNEL_STEPS))]
        run, counts = None, []
        for s in sets:
            run = s if run is None else np.intersect1d(run, s)
            counts.append(int(len(run)))
        rows.append([name, counts])
    out["c_funnel"] = sorted(rows)
    ts, step, region = (np.concatenate([p["c_maxstep"][k] for p in parts])
                        for k in range(3))
    out["c_maxstep"] = sorted(
        [name, _max_step(ts[region == r], step[region == r],
                         len(MAXSTEP_STEPS), MAXSTEP_WINDOW_MS)]
        for r, name in enumerate(REGIONS))
    return out


def build_index_segment(task):
    """Build one segment of `ssb_st`, `events` or `vecs` (a worker of
    index_tables' process pool): (table, seconds, the rows the query
    oracles need)."""
    from pinot_tpu_torch.segment.builder import MultiValues, SegmentBuilder
    from pinot_tpu_torch.spi.data_types import Schema
    from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

    table, i, seed, part, path, extra = task
    t0 = time.perf_counter()
    out = None
    if table == CLICKS_TABLE:
        schema = Schema.build(table, dimensions=CLICKS_DIMS,
                              metrics=CLICKS_METRICS)
        cfg = IndexingConfig(**CLICKS_INDEXING)
        cols, page, region = clicks_columns(i, part)
        out = clicks_partials(cols, page, region)
    elif table == ST_TABLE:
        schema = Schema.build(table, dimensions=SCHEMA_DIMS,
                              metrics=SCHEMA_METRICS)
        cfg = IndexingConfig(no_dictionary_columns=RAW_COLUMNS,
                             star_tree_index_configs=[ST_CONFIG])
        cols = part
    elif table == EVENTS_TABLE:
        schema = Schema.build(table, dimensions=EVENTS_DIMS,
                              metrics=[("lo_revenue", "INT")])
        cfg = IndexingConfig(
            no_dictionary_columns=["lo_revenue", "lo_quantity"],
            json_index_columns=["attrs"], text_index_columns=["msg"],
            custom_index_configs={"props": {"type": "map", "maxKeys": 8}})
        strings, out = _events_columns(np.random.default_rng([seed, i]),
                                       len(part["d_year"]))
        cols = dict(part, **strings)
    else:
        centres, query = extra
        rng = np.random.default_rng([seed, i])
        n = len(part["d_year"])
        emb = (centres[rng.integers(0, len(centres), n)]
               + rng.normal(0.0, VEC_NOISE, (n, VEC_DIM))).astype(np.float32)
        schema = Schema.build(table, dimensions=[("d_year", "INT"),
                                                 ("emb", "FLOAT", False)],
                              metrics=[("lo_revenue", "INT")])
        cfg = IndexingConfig(no_dictionary_columns=["lo_revenue"],
                             vector_index_columns=["emb"])
        cols = dict(part, emb=MultiValues(emb.reshape(-1),
                                          np.full(n, VEC_DIM)))
        # the exact top-K by cosine, in float64: the recall oracle
        e64 = emb.astype(np.float64)
        sims = (e64 / np.linalg.norm(e64, axis=1, keepdims=True)) @ (
            query / np.linalg.norm(query))
        out = np.argsort(-sims, kind="stable")[:VEC_K]
    SegmentBuilder(schema, TableConfig(table_name=table, indexing=cfg),
                   f"{table}_{i}").build(cols, path)
    return table, i, time.perf_counter() - t0, out


def submit_index_builds(args, tmp: str, pool) -> dict:
    """Start building the `events` and `vecs` segments in the worker pool
    (they need none of the ssb rows, so they build while phase data builds
    the other tables): `events`, gen_ssb rows from EVENTS_SEED with JSON,
    text and map index columns, 4 x --events-rows; `vecs`, --vec-rows rows
    a segment with a VEC_DIM-wide embedding (Gaussian around VEC_CENTRES
    centres) and a vector index. Returns the pending builds, the events'
    ssb rows and the query vector."""
    ev_rows, vec_rows = args.events_rows, args.vec_rows
    ev = gen_ssb(ev_rows * INDEX_SEGMENTS, EVENTS_SEED)
    ev = {k: ev[k] for k in EVENTS_SSB}
    tasks = [(EVENTS_TABLE, i, EVENTS_SEED,
              {k: v[i * ev_rows:(i + 1) * ev_rows] for k, v in ev.items()},
              f"{tmp}/{EVENTS_TABLE}_{i}", None)
             for i in range(INDEX_SEGMENTS)]
    rng = np.random.default_rng(VEC_SEED)
    centres = rng.normal(size=(VEC_CENTRES, VEC_DIM))
    query = (centres[0] + rng.normal(0.0, VEC_NOISE, VEC_DIM)).astype(
        np.float32)
    vec = gen_ssb(vec_rows * INDEX_SEGMENTS, VEC_SEED)
    vec = {k: vec[k] for k in ("d_year", "lo_revenue")}
    tasks += [(VEC_TABLE, i, VEC_SEED,
               {k: v[i * vec_rows:(i + 1) * vec_rows] for k, v in vec.items()},
               f"{tmp}/{VEC_TABLE}_{i}", (centres, query))
              for i in range(INDEX_SEGMENTS)]
    tasks += [(CLICKS_TABLE, i, CLICKS_SEED, CLICKS_ROWS,
               f"{tmp}/{CLICKS_TABLE}_{i}", None)
              for i in range(INDEX_SEGMENTS)]
    return {"t0": time.perf_counter(), "ev": ev, "query": query,
            "futures": [pool.submit(build_index_segment, t) for t in tasks]}


def index_tables(args, cols: dict, tmp: str, pool, pending: dict):
    """The three index tables, their segments built in the worker pool (the
    JSON and text index builds are host Python): `ssb_st`, the ssb rows
    with a star-tree (ST_CONFIG), in --segments segments, submitted here,
    and the builds submit_index_builds started. Returns {table: (schema,
    segments)}, the expected rows of the index queries and the facts
    phase index_checks holds them to."""
    from pinot_tpu_torch.segment.loader import load_segment
    from pinot_tpu_torch.spi.data_types import Schema

    t0 = time.perf_counter()
    per = args.rows_per_segment
    futures = [pool.submit(build_index_segment, (
        ST_TABLE, i, args.seed,
        {k: v[i * per:(i + 1) * per] for k, v in cols.items()},
        f"{tmp}/{ST_TABLE}_{i}", None)) for i in range(args.segments)]
    seconds, hits, exact, clicks = {}, {}, {}, {}
    for fut in pending["futures"] + futures:
        table, i, s, out = fut.result()
        seconds.setdefault(table, []).append(s)
        if table == CLICKS_TABLE:
            clicks[i] = out
        elif table == EVENTS_TABLE:
            for q, m in out.items():
                hits.setdefault(q, []).append(m)
        elif table == VEC_TABLE:
            exact[i] = out
    schemas = {ST_TABLE: Schema.build(ST_TABLE, dimensions=SCHEMA_DIMS,
                                      metrics=SCHEMA_METRICS),
               EVENTS_TABLE: Schema.build(EVENTS_TABLE, dimensions=EVENTS_DIMS,
                                          metrics=[("lo_revenue", "INT")]),
               VEC_TABLE: Schema.build(VEC_TABLE, dimensions=[
                   ("d_year", "INT"), ("emb", "FLOAT", False)],
                   metrics=[("lo_revenue", "INT")]),
               CLICKS_TABLE: Schema.build(CLICKS_TABLE,
                                          dimensions=CLICKS_DIMS,
                                          metrics=CLICKS_METRICS)}
    tables = {t: (schemas[t], [load_segment(f"{tmp}/{t}_{i}")
                               for i in range(len(seconds[t]))])
              for t in schemas}
    expected, views = st_oracle(cols, args.segments, per)
    expected.update(events_oracle(pending["ev"], {q: np.concatenate(m)
                                                  for q, m in hits.items()}))
    expected.update(clicks_oracle([clicks[i] for i in sorted(clicks)]))
    emit({"phase": "index_data",
          "tables": {t: {"segments": len(s), "rows_per_segment": s[0].num_docs,
                         "star_tree_rows": [v.num_docs for x in s
                                            for v in x.star_trees()]}
                     for t, (_, s) in tables.items()},
          "workers": INDEX_WORKERS,
          "since_submit_s": time.perf_counter() - pending["t0"],
          "wait_after_data_s": time.perf_counter() - t0,
          "build_s": {t: {"per_segment": v, "sum": sum(v)}
                      for t, v in seconds.items()},
          "matching_rows": {q: int(np.concatenate(m).sum())
                            for q, m in hits.items()}})
    facts = {"st_views": views[0], "st_asia": views[1],
             "vec_exact": [exact[i] for i in sorted(exact)],
             "vec_query": pending["query"]}
    return tables, expected, facts


def st_oracle(cols: dict, segments: int, per: int) -> dict:
    """st_avg's rows by numpy (st_q2, st_q9 and st_bypass are q2, q9 and
    q1 over the same rows: their oracles), and the pre-aggregated rows each
    segment's tree holds, in all and for ASIA (what st_q2 scans)."""
    year = cols["d_year"].astype(np.int64) - 1992
    region = np.zeros(len(year), dtype=np.int64)
    for k, r in enumerate(REGIONS):
        region[cols["s_region"] == r] = k
    key = (year * len(REGIONS) + region) * 1000 + cols["p_brand"]
    views, asia = [], []
    for i in range(segments):
        occ = np.bincount(key[i * per:(i + 1) * per],
                          minlength=7 * len(REGIONS) * 1000) > 0
        views.append(int(occ.sum()))
        asia.append(int(occ.reshape(7, len(REGIONS), 1000)[
            :, REGIONS.index("ASIA")].sum()))
    m = (year >= 1) & (year <= 3)
    rows = []
    for k, r in enumerate(REGIONS):
        sel = m & (region == k)
        rev = cols["lo_revenue"][sel].astype(np.int64)
        qty = cols["lo_quantity"][sel].astype(np.int64)
        if len(rev):
            rows.append([r, int(len(rev)), float(rev.sum()) / len(rev),
                         float(qty.max() - qty.min())])
    return {"st_avg": rows}, (views, asia)


def vec_cpu_rows(schema, segments) -> list:
    """ix_vec's oracle rows: the port's CPU run over the same segments (the
    IVF top-K is the index's own; phase index_checks holds its recall
    against the exact top-K)."""
    from pinot_tpu_torch.engine.query_executor import QueryExecutor

    cpu = QueryExecutor(device="cpu")
    cpu.add_table(schema, segments)
    return cpu.execute_sql(QUERIES["ix_vec"]).result_table.rows


def events_oracle(ev: dict, hits: dict) -> dict:
    """ix_json, ix_text and ix_map over the events rows: the matching rows
    from the drawn values, grouped and summed by numpy."""
    out = {}
    year = ev["d_year"].astype(np.int64)
    rev = ev["lo_revenue"].astype(np.float64)
    for q in ("ix_json", "ix_text"):
        m = hits[q] & ((ev["s_region"] == "ASIA") if q == "ix_text" else True)
        cnt = np.bincount(year[m] - 1992, minlength=7)
        tot = np.bincount(year[m] - 1992, weights=rev[m], minlength=7)
        out[q] = [[1992 + y, int(cnt[y]), float(tot[y])]
                  for y in np.flatnonzero(cnt)]
    m = hits["ix_map"]
    out["ix_map"] = [[r, int((m & (ev["s_region"] == r)).sum()),
                      float(rev[m & (ev["s_region"] == r)].sum())]
                     for r in REGIONS if (m & (ev["s_region"] == r)).any()]
    return out


def phase_index_checks(qe, results, facts, card):
    """What the index queries promise beyond their rows: the star-tree
    queries ran over the pre-aggregated views (st_q2 scanned the views'
    ASIA rows, not the table's) and st_bypass did not (it scanned as q1
    did), and st_avg's COUNT and AVG read one count pair; ix_vec keeps
    VEC_K rows a segment, and its per-segment top-K recall against the
    exact cosine top-K is at least VEC_RECALL; the mask planes each index query uploads and the host
    ms of evaluating them."""
    from pinot_tpu_torch.engine import ir, plan as plan_mod
    from pinot_tpu_torch.query.parser.sql import parse_sql

    st_rows = sum(facts["st_views"])
    for qname in ST_QUERIES:
        routes = qe.route_segments(parse_sql(QUERIES[qname]),
                                   qe._table(ST_TABLE).segments)
        rewritten = [r.rewrite is not None for r in routes]
        if rewritten != [qname != "st_bypass"] * len(routes):
            raise AssertionError(f"{qname}: star-tree routes {rewritten}")
        if qname == "st_avg":
            inner = [str(a) for a in routes[0].query.aggregations]
            if inner.count("sum(__count__star)") != 1:
                raise AssertionError(f"st_avg's COUNT and AVG read {inner}")
    if results["st_q2"].num_docs_scanned != sum(facts["st_asia"]):
        raise AssertionError(
            f"st_q2 scanned {results['st_q2'].num_docs_scanned} docs, the "
            f"views hold {sum(facts['st_asia'])} ASIA rows")
    if results["st_bypass"].num_docs_scanned != results["q1"].num_docs_scanned:
        raise AssertionError("st_bypass scanned another row count than q1")
    vt = qe._table(VEC_TABLE)
    top = sum(r[1] for r in results["ix_vec"].result_table.rows)
    if top != VEC_K * len(vt.segments):
        raise AssertionError(f"ix_vec counted {top} rows, not {VEC_K} a "
                             "segment")
    recall = []
    for seg, want in zip(vt.segments, facts["vec_exact"]):
        got, _ = seg.get_vector_index("emb").top_k(facts["vec_query"], VEC_K)
        recall.append(len(np.intersect1d(got, want)) / VEC_K)
    if min(recall) < VEC_RECALL:
        raise AssertionError(f"ix_vec recall@{VEC_K} {recall}")
    masks = {}
    for qname in INDEX_QUERIES:
        timed = {"ms": 0.0}

        def timer(fn):
            def call(*a):
                t = time.perf_counter()
                try:
                    return fn(*a)
                finally:
                    timed["ms"] += (time.perf_counter() - t) * 1e3
            return call

        orig = plan_mod.eval_host_mask, plan_mod.eval_map_index_predicate
        plan_mod.eval_host_mask, plan_mod.eval_map_index_predicate = map(
            timer, orig)
        try:
            query_ctx = parse_sql(QUERIES[qname])
            segments, _ = qe.prune_segments(query_ctx, qe.pinned_segments(
                qe._table(query_ctx.table_name).segments))
            plans = qe.plan_segments(qe.route_segments(query_ctx, segments))
        finally:
            plan_mod.eval_host_mask, plan_mod.eval_map_index_predicate = orig
        planes = [np.asarray(pl.params[m.idx]) for pl in plans
                  for m in _mask_params(pl.program.filter, ir)]
        if len(planes) != len(plans):
            raise AssertionError(f"{qname}: {len(planes)} mask planes for "
                                 f"{len(plans)} segments")
        masks[qname] = {"mask_planes": len(planes),
                        "mask_bytes": sum(p.nbytes for p in planes),
                        "mask_eval_ms": timed["ms"]}
    emit({"phase": "index_checks", "card": card,
          "star_tree_rows": st_rows,
          "st_q2_docs_scanned": results["st_q2"].num_docs_scanned,
          "st_bypass_docs_scanned": results["st_bypass"].num_docs_scanned,
          "vec_recall": recall, "masks": masks})


def _mask_params(node, ir) -> list:
    """The ir.MaskParam leaves of a filter tree."""
    if node is None:
        return []
    if isinstance(node, ir.MaskParam):
        return [node]
    kids = getattr(node, "children", None) or (
        [node.child] if isinstance(node, ir.FNot) else [])
    return [m for k in kids for m in _mask_params(k, ir)]


def family_count(qe, sql, table=None) -> int:
    """Batch families (and lone segments) the query's plans form: the
    device dispatches it makes outside the device combine's merge. `table`
    names the executor's table when it differs from the query's (a cluster
    server's `ssb_OFFLINE`)."""
    from pinot_tpu_torch.query.parser.sql import parse_sql

    query = parse_sql(sql)
    if table is not None:
        query.table_name = table
    segments, _ = qe.prune_segments(
        query, qe.pinned_segments(qe._table(query.table_name).segments))
    routes = qe.route_segments(query, segments)
    plans = qe.plan_segments(routes)
    return len(qe._batch_families(query, [r.segment for r in routes],
                                  plans)), {p.program.mode for p in plans}


def phase_timeseries(args, torch, qe, expected, _cuda, mxu, fg, card) -> dict:
    """The timeseries engine (timeseries/) over `ssbt` on the card: each
    TS_QUERIES query once through TimeSeriesEngine(qe).execute with every
    count set to 0 just before it (one launch of kernel A over the family,
    no other), its block's JSON equal to the numpy oracle's; its fetch and
    its pipe stages timed apart (--iters runs, host clock, the fetch ending
    in a synchronize); the same query --iters times through POST
    /timeseries/api/v1/query_range of a BrokerRestServer holding the
    engine, each answer the oracle's. The fetch over the raw lo_commit_ts
    raises TimeSeriesQueryError in process and answers 500 over REST."""
    from pinot_tpu_torch.cluster import Broker, PropertyStore
    from pinot_tpu_torch.cluster.rest import BrokerRestServer
    from pinot_tpu_torch.timeseries import TimeBuckets, TimeSeriesEngine
    from pinot_tpu_torch.timeseries.engine import (TimeSeriesQueryError,
                                                   parse_m3ql)

    t_phase = time.perf_counter()
    engine = TimeSeriesEngine(qe)
    broker = Broker(PropertyStore())
    rest = BrokerRestServer(broker, timeseries_engine=engine)
    url = rest.url + "/timeseries/api/v1/query_range"
    out, recs, launches, parity = {}, {}, {}, {}
    try:
        for qname, (query, start, end, step) in TS_QUERIES.items():
            want = expected[qname]
            _cuda.reset_launches()
            with recording(mxu, "limb_sums") as a_calls:
                block = engine.execute(query, start, end, step)
                torch.cuda.synchronize()
            made = dict(_cuda.LAUNCHES)
            if made != {"limb_sums": 1, "fused_limb_sums": 0}:
                raise AssertionError(f"timeseries {qname}: launches {made}")
            if block.to_json() != want:
                raise AssertionError(f"timeseries {qname}: the block differs "
                                     "from the oracle's")
            recs[qname], launches[qname] = list(a_calls), made
            parity[qname] = check_equal(
                torch, f"limb_sums timeseries {qname}",
                mxu.limb_sums(*a_calls[0]), mxu.limb_sums_plain(*a_calls[0]))
            plan = parse_m3ql(query)
            buckets = TimeBuckets.for_range(start, end, step)
            fetch_ms, pipe_ms, rest_ms = [], [], []
            for _ in range(args.iters):
                t0 = time.perf_counter()
                fetched = engine._fetch(plan.fetch, buckets, start, end, step)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                piped = fetched
                for stage in plan.stages:
                    piped = engine._apply(stage, piped)
                t2 = time.perf_counter()
                fetch_ms.append((t1 - t0) * 1e3)
                pipe_ms.append((t2 - t1) * 1e3)
                if piped.to_json() != want:
                    raise AssertionError(f"timeseries {qname}: a timed run "
                                         "differs from the oracle")
            for _ in range(args.iters):
                t0 = time.perf_counter()
                code, body = _http(url, {"query": query, "start": start,
                                         "end": end, "step": step})
                rest_ms.append((time.perf_counter() - t0) * 1e3)
                if code != 200 or body != want:
                    raise AssertionError(f"timeseries {qname} over REST: "
                                         f"{code}")
            out[qname] = {
                "fetch_p50_ms": float(np.median(fetch_ms)),
                "pipe_p50_ms": float(np.median(pipe_ms)),
                "rest_p50_ms": float(np.median(rest_ms)),
                "buckets": buckets.num_buckets,
                "series": len(want["series"]),
                "groups": int(sum(np.count_nonzero(~np.isnan(s.values))
                                  for s in fetched.series)),
                "kernel_G": int(a_calls[0][2]),
                "family": list(a_calls[0][0].shape), "launches": made}
        try:
            engine.execute(*TS_RAW)
        except TimeSeriesQueryError as e:
            raw = str(e)
        else:
            raise AssertionError("timeseries: the raw time column's fetch "
                                 "was not refused")
        query, start, end, step = TS_RAW
        code, body = _http(url, {"query": query, "start": start, "end": end,
                                 "step": step})
        if code != 500 or not body["error"].startswith(
                "TimeSeriesQueryError: fetch failed"):
            raise AssertionError(f"timeseries raw over REST: {code} {body}")
        out["raw"] = {"error": raw[:160], "rest_status": code}
    finally:
        rest.close()
        broker.close()
    emit(dict({"phase": "timeseries", "card": card, "table": TIME_TABLE,
               "oracle": "equal", "iters": args.iters,
               "seconds": time.perf_counter() - t_phase,
               "note": "host clock; the fetch ends in a synchronize; REST "
                       "over loopback in this process"}, **out))
    return {"recs": recs, "launches": launches, "parity": parity}


def phase_queries(torch, qe, expected, _cuda, interp, names=None):
    """The main path: every query once (or the queries `names`), each with
    its launches, device dispatches and host fetches counted from 0 just
    before it, held against the oracle and the structure each slice
    promises."""
    results = {}
    _cuda.reset_launches()
    per_query, cold, fetches, combines = {}, {}, {}, {}
    for qname in names or QUERIES:
        sql = QUERIES[qname]
        _cuda.reset_launches()
        fetch0 = interp.host_fetches()
        resident = qe.executor.cache.bytes_used()
        with recording(interp, "combine_sparse_group_tables") as merged:
            t0 = time.perf_counter()
            resp = qe.execute_sql(sql)
            torch.cuda.synchronize()
        # the first run uploads the planes the query needs and has not
        # found resident yet (and builds a family's stacks)
        cold[qname] = {"ms": (time.perf_counter() - t0) * 1e3,
                       "uploaded_bytes": qe.executor.cache.bytes_used() - resident}
        per_query[qname] = dict(_cuda.LAUNCHES)
        fetches[qname] = interp.host_fetches() - fetch0
        combines[qname] = len(merged)
        results[qname] = resp
    launches = {k: sum(q[k] for q in per_query.values()) for k in _cuda.LAUNCHES}
    families = {}
    for qname, resp in results.items():
        got = [tuple(r) for r in resp.result_table.rows]
        want = [tuple(r) for r in expected[qname]]
        if qname not in ORDERED:
            got, want = sorted(got), sorted(want)
        if got != want:
            bad = next((a, b) for a, b in zip(got + [None] * len(want),
                                              want + [None] * len(got))
                       if a != b)
            raise AssertionError(f"{qname}: {len(got)} rows vs oracle "
                                 f"{len(want)}; first difference {bad}")
        kernel = EXPECTED_KERNEL.get(qname)
        if kernel is not None and per_query[qname][kernel] == 0:
            raise AssertionError(f"{qname} did not launch {kernel}")
        if fetches[qname] != min(1, resp.num_device_dispatches):
            raise AssertionError(f"{qname}: {fetches[qname]} host fetches")
        pruned, dispatches = PRUNED.get(qname, (0, None))
        if resp.num_segments_pruned != pruned or dispatches not in (
                None, resp.num_device_dispatches):
            raise AssertionError(
                f"{qname}: {resp.num_segments_pruned} segments pruned, "
                f"{resp.num_device_dispatches} dispatches")
        families[qname], modes = family_count(qe, QUERIES[qname])
        if qname in ONE_FAMILY and (resp.num_device_dispatches != 1
                                    or families[qname] != 1):
            raise AssertionError(f"{qname}: {resp.num_device_dispatches} "
                                 f"dispatches, {families[qname]} families")
        want_launches = FAMILY_LAUNCHES.get(qname, 1)
        if qname in ONE_FAMILY and kernel \
                and per_query[qname][kernel] != want_launches:
            raise AssertionError(f"{qname}: {per_query[qname][kernel]} "
                                 f"launches of {kernel}, want {want_launches}")
        if qname == "q6m" and resp.num_device_dispatches != FAMILY_SEGMENTS:
            raise AssertionError(f"q6m: {resp.num_device_dispatches} "
                                 "dispatches")
        if resp.num_device_dispatches != families[qname]:
            raise AssertionError(f"{qname}: {resp.num_device_dispatches} "
                                 f"dispatches for {families[qname]} families")
        if (modes == {"group_by_sparse"}) != (qname in SPARSE_QUERIES):
            raise AssertionError(f"{qname}: planned modes {modes}")
        if (combines[qname] == 1) != (qname in DEVICE_COMBINE):
            raise AssertionError(f"{qname}: {combines[qname]} device combines")
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"the main path never launched {k}")
    from pinot_tpu_torch.query.parser.sql import parse_sql

    refused = {}
    for sql in () if names else MV_REFUSED + TRANSFORM_REFUSED:
        try:
            qe.execute(parse_sql(sql))
        except interp_unsupported() as e:
            refused[sql] = str(e)
        else:
            raise AssertionError(f"not refused: {sql}")
    emit({"phase": "queries", "rows_checked": {k: len(r.result_table.rows)
                                               for k, r in results.items()},
          "refused": refused,
          "segments_pruned": {k: r.num_segments_pruned
                              for k, r in results.items()},
          "oracle": "equal", "launches": launches,
          "launches_per_query": per_query, "first_run": cold,
          "host_fetches": fetches, "device_combines": combines,
          "batch_families": families,
          "docs_scanned": {k: r.num_docs_scanned for k, r in results.items()},
          "device_dispatches": {k: r.num_device_dispatches
                                for k, r in results.items()},
          "resident_bytes": qe.executor.cache.bytes_used(),
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    return launches, per_query, results


# -- phase segment_formats ----------------------------------------------------


def formats_table(evolved: bool):
    """(schema, table config) of `ssbz`: the schema its segments are built
    with, or (`evolved`) the one it is registered under, which adds
    s_nation and lo_tax."""
    from pinot_tpu_torch.spi.data_types import Schema
    from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

    schema = Schema.build(
        FORMATS_TABLE,
        dimensions=FORMATS_DIMS + (FORMATS_ADDED_DIMS if evolved else []),
        metrics=FORMATS_METRICS + (FORMATS_ADDED_METRICS if evolved else []))
    return schema, TableConfig(table_name=FORMATS_TABLE, indexing=IndexingConfig(
        no_dictionary_columns=FORMATS_RAW, compression_configs=FORMATS_CODECS,
        bloom_filter_columns=["s_region"],
        segment_partition_config={"lo_orderkey": {
            "functionName": "modulo", "numPartitions": FORMATS_SEGMENTS}}))


def formats_strings(cols: dict, rows=slice(None)) -> tuple:
    """The note and log line of each row of `rows`: lo_note names the order,
    lo_log fills a template chosen by lo_discount (each distinct line
    formatted once)."""
    notes = [f"order-{k}" for k in cols["lo_orderkey"][rows].tolist()]
    t = (cols["lo_discount"][rows] % len(LOG_TEMPLATES)).astype(np.int64)
    q = cols["lo_quantity"][rows].astype(np.int64)
    b = (cols["p_brand"][rows] % 100).astype(np.int64)
    y = cols["d_year"][rows].astype(np.int64)
    code = ((t * 64 + q) * 128 + b) * 4096 + y
    uniq, inv = np.unique(code, return_inverse=True)
    lines = np.asarray([LOG_TEMPLATES[c >> 25].format(
        q=(c >> 19) & 63, b=(c >> 12) & 127, y=c & 4095)
        for c in uniq.tolist()], dtype=object)
    return notes, lines[inv].tolist()


def formats_columns(cols: dict, rows: int) -> list:
    """`ssbz`'s segments from phase `data`'s rows: segment k the first
    `rows` rows whose lo_orderkey is k modulo FORMATS_SEGMENTS (their keys
    still sorted)."""
    residue = cols["lo_orderkey"] % FORMATS_SEGMENTS
    parts = []
    for k in range(FORMATS_SEGMENTS):
        idx = np.nonzero(residue == k)[0][:rows]
        if len(idx) != rows:
            raise AssertionError(f"{len(idx)} rows of residue {k}")
        parts.append({c: cols[c][idx] for c in FORMATS_NUMERIC})
    return parts


def build_formats_segment(task):
    """Build one `ssbz` segment (a worker of the spawn process pool), its
    strings made here from the numeric columns: (index, seconds)."""
    from pinot_tpu_torch.segment.builder import SegmentBuilder

    i, part, path = task
    t0 = time.perf_counter()
    notes, logs = formats_strings(part)
    cols = {c: part[c] for c, _ in FORMATS_DIMS + FORMATS_METRICS
            if c in part}
    cols["lo_note"] = np.asarray(notes, dtype=object)
    cols["lo_log"] = np.asarray(logs, dtype=object)
    schema, cfg = formats_table(evolved=False)
    SegmentBuilder(schema, cfg, f"{FORMATS_TABLE}_{i}").build(cols, path)
    return i, time.perf_counter() - t0


def formats_oracle(parts: list) -> tuple:
    """The rows of FORMATS_QUERIES from the numpy columns, the partition
    query's key (a key of segment 1 inside every segment's key range, so
    only the partition stamps prune) and the pruned / processed segments
    the data implies for the two pruned queries."""
    cat = {c: np.concatenate([p[c] for p in parts]) for c in FORMATS_NUMERIC}
    year, rev = cat["d_year"], cat["lo_revenue"].astype(np.int64)
    want = {"z_year": [[int(y), float(rev[year == y].sum())]
                       for y in np.unique(year)]}
    asia = cat["s_region"] == "ASIA"
    keys = year[asia].astype(np.int64) * 1000 + cat["p_brand"][asia]
    uniq, inv = np.unique(keys, return_inverse=True)
    sums = np.bincount(inv, weights=rev[asia]).astype(np.int64)
    want["z_q2_family"] = want["z_q2"] = [
        [int(k // 1000), int(k % 1000), float(v)] for k, v in zip(uniq, sums)]
    want["z_evolved"] = [["null", 0.0, len(year)]]
    rows = []
    for p in parts:
        idx = np.nonzero(p["d_year"] == 1995)[0][:10 - len(rows)]
        notes, logs = formats_strings(p, idx)
        rows += [[n, g, int(r)] for n, g, r in
                 zip(notes, logs, p["lo_revenue"][idx].tolist())]
        if len(rows) == 10:
            break
    want["z_select"] = rows
    want["z_bloom"] = [[0]]
    seg1 = parts[1]["lo_orderkey"]
    key = int(seg1[len(seg1) // 2])
    if not all(p["lo_orderkey"].min() <= key <= p["lo_orderkey"].max()
               for p in parts):
        raise AssertionError(f"key {key} outside a segment's key range")
    if not all(min(p["s_region"]) < BLOOM_PROBE < max(p["s_region"])
               for p in parts):
        raise AssertionError(f"{BLOOM_PROBE} outside a segment's range")
    hit = cat["lo_orderkey"] == key
    want["z_partition"] = [[int(hit.sum()), float(rev[hit].sum())]]
    holders = sum(int((p["lo_orderkey"] == key).any()) for p in parts)
    pruned = {"z_bloom": (len(parts), 0),
              "z_partition": (len(parts) - holders, holders)}
    return want, key, pruned


def phase_segment_formats(args, torch, qe, dirs, parts, build_s, _cuda, mxu,
                          fg, card) -> dict:
    """`ssbz` on the card: its compressed, var-width, CLP, bloom and
    partition-stamped segments loaded (per codec the ms of the first read
    of each compressed buffer, decompressing it, and its MB/s; the ms of
    decoding a whole var-width and CLP column of one segment), registered
    under the schema that adds s_nation and lo_tax, and each of
    FORMATS_QUERIES run with its counts set to 0 just before it and read
    just after, its rows held against the numpy oracle, its dispatches,
    kernel launches and pruned / processed segments against what the
    query implies; then cold and warm p50s. Returns each kernel launch's
    recorded inputs (held against the plain version here) and the
    launches."""
    from pinot_tpu_torch.segment.loader import load_segment

    t_phase = time.perf_counter()
    want, key, pruned_want = formats_oracle(parts)
    queries = dict(FORMATS_QUERIES)
    queries["z_partition"] = queries["z_partition"].format(key=key)
    t0 = time.perf_counter()
    segs = [load_segment(d) for d in dirs]
    load_ms = (time.perf_counter() - t0) * 1e3
    decode = {}
    for seg in segs:
        for name, entry in seg.metadata.buffers.items():
            if len(entry) != 3:
                continue
            t0 = time.perf_counter()
            raw = seg._buffer(name)
            ms = (time.perf_counter() - t0) * 1e3
            d = decode.setdefault(entry[2], {"buffers": 0, "ms": 0.0,
                                             "bytes": 0, "stored_bytes": 0})
            d["buffers"] += 1
            d["ms"] += ms
            d["bytes"] += len(raw)
            d["stored_bytes"] += entry[1]
    for d in decode.values():
        d["mb_per_s"] = d["bytes"] / 1e6 / (d["ms"] / 1e3)
    if set(decode) != {"LZ4", "SNAPPY", "GZIP"}:
        raise AssertionError(f"compressed buffers of codecs {sorted(decode)}")
    # a whole var-width and CLP column of one segment, on its own copy:
    # the table's segments decode only the rows a selection returns
    alone = load_segment(dirs[0], verify=False)
    var_ms = {}
    for col in ("lo_note", "lo_log"):
        t0 = time.perf_counter()
        vals = alone.get_values(col)
        var_ms[col] = (time.perf_counter() - t0) * 1e3
        if len(vals) != alone.num_docs:
            raise AssertionError(f"{col}: {len(vals)} values")
    notes, logs = formats_strings(parts[0], slice(0, 1000))
    if alone.get_values("lo_note")[:1000].tolist() != notes \
            or alone.get_values("lo_log")[:1000].tolist() != logs:
        raise AssertionError("decoded var-width values differ from the input")
    del alone, vals
    schema, _ = formats_table(evolved=True)
    qe.add_table(schema, segs)

    kernel_of = {"z_year": "limb_sums", "z_q2_family": "limb_sums",
                 "z_evolved": "limb_sums", "z_q2": "fused_limb_sums"}
    dispatches_want = {"z_year": 1, "z_q2_family": 1, "z_evolved": 1,
                       "z_q2": len(segs), "z_select": 1, "z_bloom": 0,
                       "z_partition": 1}
    per_query, results, recs, cold = {}, {}, {}, {}
    for qname, sql in queries.items():
        kernel = kernel_of.get(qname)
        owner = fg if kernel == "fused_limb_sums" else mxu
        _cuda.reset_launches()
        with recording(owner, kernel or "limb_sums") as calls:
            t0 = time.perf_counter()
            resp = qe.execute_sql(sql)
            torch.cuda.synchronize()
            cold[qname] = (time.perf_counter() - t0) * 1e3
        per_query[qname] = dict(_cuda.LAUNCHES)
        results[qname] = resp
        got = [list(r) for r in resp.result_table.rows]
        exp = want[qname]
        if qname != "z_select":
            got, exp = sorted(map(tuple, got)), sorted(map(tuple, exp))
        if got != exp:
            raise AssertionError(f"{qname}: rows differ from the oracle "
                                 f"({len(got)} vs {len(exp)} rows)")
        if resp.num_device_dispatches != dispatches_want[qname]:
            raise AssertionError(f"{qname}: {resp.num_device_dispatches} "
                                 "dispatches")
        launched = {k: v for k, v in per_query[qname].items() if v}
        launches_want = {kernel: len(calls)} if kernel else {}
        if kernel and len(calls) != (len(segs) if qname == "z_q2" else 1):
            raise AssertionError(f"{qname}: {len(calls)} calls of {kernel}")
        if launched != launches_want:
            raise AssertionError(f"{qname}: launches {launched}")
        if kernel:
            recs[qname] = (kernel, list(calls))
        p_want = pruned_want.get(qname, (0, len(segs)))
        if (resp.num_segments_pruned, resp.num_segments_processed) != p_want:
            raise AssertionError(
                f"{qname}: {resp.num_segments_pruned} pruned, "
                f"{resp.num_segments_processed} processed, want {p_want}")
    parity = {}
    for qname, (kernel, calls) in recs.items():
        for k, rec in enumerate(calls):
            label = f"{kernel}/{qname}_inputs/launch{k}"
            if kernel == "limb_sums":
                got = mxu.limb_sums(*rec)
                ref = mxu.limb_sums_plain(*rec)
            else:
                got = fg.fused_limb_sums(*rec)
                ref = fg.fused_limb_sums_plain(*rec)
            parity[label] = check_equal(torch, label, got, ref)
    iters = min(args.iters, 5)
    warm = {}
    for qname, sql in queries.items():
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            qe.execute_sql(sql)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        warm[qname] = float(np.median(ts))
    emit({"phase": "segment_formats", "card": card, "table": FORMATS_TABLE,
          "segments": len(segs), "rows_per_segment": segs[0].num_docs,
          "build_s": build_s, "load_ms": load_ms, "decode": decode,
          "var_decode_ms": var_ms, "oracle": "equal",
          "cold_ms": cold, "warm_p50_ms": warm, "warm_iters": iters,
          "launches_per_query": per_query,
          "device_dispatches": {k: r.num_device_dispatches
                                for k, r in results.items()},
          "segments_pruned": {k: r.num_segments_pruned
                              for k, r in results.items()},
          "segments_processed": {k: r.num_segments_processed
                                 for k, r in results.items()},
          "partition_key": key, "max_abs_err": parity,
          "seconds": time.perf_counter() - t_phase})
    return {"recs": recs, "launches": per_query, "parity": parity}


@contextlib.contextmanager
def delta_timer(torch):
    """Host-clock seconds of the realtime delta work: `read`, the consuming
    segment's rows since the watermark turned into numpy (segment/mutable.py
    ids_slice, raw_slice, null_slice, dict_values_numeric), and `upload`,
    their writes into the device planes (each ending in a synchronize, so
    the host->device copy is inside)."""
    from pinot_tpu_torch.realtime.device_plane import RealtimePlaneSet
    from pinot_tpu_torch.segment.mutable import _MutableColumn

    spent = {"read": 0.0, "upload": 0.0}
    patched = [(_MutableColumn, m, "read") for m in (
        "ids_slice", "raw_slice", "null_slice", "dict_values_numeric")]
    patched.append((RealtimePlaneSet, "_upload", "upload"))
    origs = [getattr(owner, m) for owner, m, _ in patched]

    def timed(orig, key):
        def call(*args):
            t0 = time.perf_counter()
            out = orig(*args)
            if key == "upload":
                torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return out
        return call

    for (owner, m, key), orig in zip(patched, origs):
        setattr(owner, m, timed(orig, key))
    try:
        yield spent
    finally:
        for (owner, m, _), orig in zip(patched, origs):
            setattr(owner, m, orig)


def _rt_query(torch, qe, interp, device_plane, qname, sql, want):
    """One realtime query, its counters set to 0 just before it: rows held
    against `want`, 2 dispatches (the immutable family or committed
    segment, then the consuming snapshot) and 1 host fetch."""
    from pinot_tpu_torch.ops import _cuda

    _cuda.reset_launches()
    device_plane.reset_realtime_stats()
    fetch0 = interp.host_fetches()
    with delta_timer(torch) as spent:
        t0 = time.perf_counter()
        resp = qe.execute_sql(sql)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    st = dict(device_plane.realtime_stats())
    got = sorted(tuple(r) for r in resp.result_table.rows)
    if got != sorted(tuple(r) for r in want):
        raise AssertionError(f"{qname}: {len(got)} rows differ from the "
                             f"oracle's {len(want)}")
    fetches = interp.host_fetches() - fetch0
    if resp.num_device_dispatches != 2 or fetches != 1:
        raise AssertionError(f"{qname}: {resp.num_device_dispatches} "
                             f"dispatches, {fetches} host fetches")
    return {"ms": ms, "delta_bytes": st["deltaBytes"],
            "uploads": st["uploads"], "read_ms": spent["read"] * 1e3,
            "upload_ms": spent["upload"] * 1e3,
            "launches": dict(_cuda.LAUNCHES),
            "device_dispatches": resp.num_device_dispatches,
            "host_fetches": fetches}, resp


def phase_realtime(args, torch, qe, tables, rt_base, interp, tmp, card):
    """The consuming-segment path: `ssb_rt` through generations g0, g1, g2
    (each query cold, then warm; g0's warm repeat must upload nothing, g1
    grows every plane on the device into the next bucket and ships only its
    tail, below 1/8 of g0's bytes) and `ups` before and after an overwrite
    of UPS_OVERWRITE keys (visibility must flip). Each checked query's
    counts are set to 0 just before it and read just after; the phase sums
    them, and kernel A must have run. Returns the final rows of RT_QUERIES
    and the phase's launches, and the tables' state for phase `cache`."""
    from pinot_tpu_torch.ops import _cuda
    from pinot_tpu_torch.realtime import device_plane
    from pinot_tpu_torch.segment.builder import SegmentBuilder
    from pinot_tpu_torch.segment.device_cache import pad_bucket
    from pinot_tpu_torch.segment.loader import load_segment
    from pinot_tpu_torch.segment.mutable import MutableSegment
    from pinot_tpu_torch.spi.data_types import Schema
    from pinot_tpu_torch.spi.table_config import (IndexingConfig, TableConfig,
                                                  UpsertConfig)
    from pinot_tpu_torch.upsert import TableUpsertMetadataManager

    t_phase = time.perf_counter()
    _cuda.reset_launches()
    schema, ssb_segments = tables["ssb"]
    live = MutableSegment(Schema.build(RT_TABLE, dimensions=SCHEMA_DIMS,
                                       metrics=SCHEMA_METRICS), f"{RT_TABLE}_0")
    qe.add_table(live.schema, ssb_segments + [live], RT_TABLE)
    total = sum(n for _, n in RT_GENERATIONS)
    cols = gen_ssb(total, args.seed + 3)
    names = list(cols)
    rows = zip(*[cols[c].tolist() for c in names])
    planes = device_plane.REALTIME_PLANES.plane_set(live, DEVICE)
    rt_queries = ("rt_q1", "rt_q2", "rt_range")
    gens, fed, launches = {}, 0, dict(_cuda.LAUNCHES)
    for gname, add in RT_GENERATIONS:
        t0 = time.perf_counter()
        for _ in range(add):
            live.index(dict(zip(names, next(rows))))
        feed_s = time.perf_counter() - t0
        fed += add
        want = rt_expected([rt_base, rt_partials(
            {c: v[:fed] for c, v in cols.items()})])
        cap0 = planes.capacity("d_year", "ids")
        gen = {"rows": fed, "feed_s": feed_s, "feed_us_per_row":
               feed_s / add * 1e6, "queries": {}}
        for qname in rt_queries:
            gen["queries"][qname], _ = _rt_query(
                torch, qe, interp, device_plane, qname, RT_QUERIES[qname],
                want[qname])
            for k, v in gen["queries"][qname]["launches"].items():
                launches[k] += v
        if gname == "g0":
            gen["warm_repeat"] = {}
            for qname in rt_queries:
                rec, _ = _rt_query(torch, qe, interp, device_plane, qname,
                                   RT_QUERIES[qname], want[qname])
                if rec["delta_bytes"] or rec["uploads"]:
                    raise AssertionError(f"g0 warm {qname}: {rec}")
                gen["warm_repeat"][qname] = rec
        gen["warm_p50_ms"] = {}
        for qname in rt_queries:
            ts = []
            for _ in range(args.iters):
                t0 = time.perf_counter()
                qe.execute_sql(RT_QUERIES[qname])
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            gen["warm_p50_ms"][qname] = float(np.median(ts))
        gen["delta_bytes"] = sum(q["delta_bytes"]
                                 for q in gen["queries"].values())
        gen["uploads"] = sum(q["uploads"] for q in gen["queries"].values())
        for key in ("read_ms", "upload_ms"):
            gen[key] = sum(q[key] for q in gen["queries"].values())
        gen["plane_capacity_rows"] = planes.capacity("d_year", "ids")
        gen["plane_bytes"] = planes.nbytes()
        if gen["plane_capacity_rows"] != pad_bucket(fed):
            raise AssertionError(f"{gname}: planes hold "
                                 f"{gen['plane_capacity_rows']} rows for "
                                 f"{fed}")
        gen["grew_on_device"] = cap0 not in (0, gen["plane_capacity_rows"])
        gens[gname] = gen
    if not gens["g1"]["grew_on_device"] or gens["g0"]["grew_on_device"]:
        raise AssertionError("g1 did not cross into the next bucket")
    if not 0 < gens["g1"]["delta_bytes"] < gens["g0"]["delta_bytes"] / 8:
        raise AssertionError(f"g1 shipped {gens['g1']['delta_bytes']} bytes "
                             f"against g0's {gens['g0']['delta_bytes']}")
    live_parts = rt_partials(cols)
    final = rt_expected([rt_base, live_parts])
    del cols, rows

    # -- ups: an upsert table of a committed and a consuming segment ------
    t0 = time.perf_counter()
    n_all = 2 * UPS_ROWS + UPS_OVERWRITE
    ucols = gen_ssb(n_all, args.seed + 4)
    ucols["pk"] = np.random.default_rng(args.seed + 5).integers(
        0, UPS_KEYS, n_all)
    ts = np.arange(n_all, dtype=np.int64)
    stale = np.arange(n_all) % UPS_STALE_EVERY == UPS_STALE_EVERY - 1
    ts[stale] = -1 - ts[stale]
    ucols["ts"] = ts
    uschema = Schema.build(UPS_TABLE, dimensions=SCHEMA_DIMS + [("pk", "LONG")],
                           metrics=SCHEMA_METRICS, date_times=[("ts", "LONG")],
                           primary_key_columns=["pk"])
    cfg = TableConfig(table_name=UPS_TABLE, indexing=IndexingConfig(
        no_dictionary_columns=RAW_COLUMNS + ["pk", "ts"]),
        upsert=UpsertConfig(mode="FULL", comparison_columns=["ts"]))
    mgr = TableUpsertMetadataManager(uschema, cfg)
    d = f"{tmp}/{UPS_TABLE}_0"
    SegmentBuilder(uschema, cfg, f"{UPS_TABLE}_0").build(
        {c: v[:UPS_ROWS] for c, v in ucols.items()}, d)
    committed = load_segment(d)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mgr.add_segment(committed)
    replay_s = time.perf_counter() - t0
    consuming = MutableSegment(uschema, f"{UPS_TABLE}_1")
    qe.add_table(uschema, [committed, consuming], UPS_TABLE)
    unames = list(ucols)
    urows = zip(*[ucols[c][UPS_ROWS:].tolist() for c in unames])
    ups = {"committed_rows": UPS_ROWS, "build_s": build_s,
           "replay_s": replay_s}
    prev = None
    for label, add in (("before", UPS_ROWS), ("after", UPS_OVERWRITE)):
        t0 = time.perf_counter()
        for _ in range(add):
            r = dict(zip(unames, next(urows)))
            mgr.add_record(consuming, consuming.index(r), r)
        feed_s = time.perf_counter() - t0
        n = UPS_ROWS + consuming.num_docs
        want = ups_expected({c: v[:n] for c, v in ucols.items()},
                            ucols["pk"][:n], ucols["ts"][:n])
        rec, resp = _rt_query(torch, qe, interp, device_plane, "ups",
                              RT_QUERIES["ups"], want)
        for k, v in rec["launches"].items():
            launches[k] += v
        rec.update(feed_s=feed_s, feed_us_per_row=feed_s / add * 1e6,
                   consuming_rows=consuming.num_docs,
                   primary_keys=mgr.num_primary_keys(),
                   valid_docs=committed.valid_doc_ids.num_valid(UPS_ROWS)
                   + consuming.valid_doc_ids.num_valid(consuming.num_docs))
        got = sorted(tuple(r) for r in resp.result_table.rows)
        if got == prev:
            raise AssertionError("ups: the overwrite did not flip visibility")
        prev = got
        ups[label] = rec
    final["ups"] = want
    # what phase `cache` feeds on: the consuming segments, the upsert
    # manager and the oracle's columns of every ups row so far
    state = {"live": live, "live_parts": [rt_base, live_parts],
             "ups_mgr": mgr, "ups_committed": committed,
             "ups_consuming": consuming, "ups_schema": uschema,
             "ups_cols": {c: ucols[c][:UPS_ROWS + consuming.num_docs]
                          for c in ("pk", "ts", "s_region", "d_year",
                                    "lo_revenue")}}
    del ucols
    if launches["limb_sums"] == 0:
        raise AssertionError("the realtime path never launched limb_sums")
    emit({"phase": "realtime", "card": card,
          "generations": gens, "ups": ups, "launches": launches,
          "rt_plane_bytes": planes.nbytes(),
          "registry": device_plane.REALTIME_PLANES.stats(),
          "seconds": time.perf_counter() - t_phase})
    return final, launches, state


@contextlib.contextmanager
def ingest_timers():
    """Host-clock time inside the realtime managers while active, per call
    (the consumer threads call them): `index`, each fetched batch through
    decode + transform + index (RealtimeSegmentDataManager._index_batch)
    with its rows; `build`, each sealed segment converted and built
    (RealtimeSegmentConverter.convert); `load`, each build loaded
    (realtime/manager.py load_segment); `download`, a losing replica's
    copy of the winner's build, its load included
    (RealtimeTableDataManager._handle_discard)."""
    from pinot_tpu_torch.realtime import converter, manager

    spent = {"index": [], "index_rows": 0, "build": [], "load": [],
             "download": []}
    patched = [(manager.RealtimeSegmentDataManager, "_index_batch", "index"),
               (converter.RealtimeSegmentConverter, "convert", "build"),
               (manager, "load_segment", "load"),
               (manager.RealtimeTableDataManager, "_handle_discard",
                "download")]
    origs = [getattr(owner, m) for owner, m, _ in patched]
    lock = threading.Lock()

    def timed(orig, key):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            ms = (time.perf_counter() - t0) * 1e3
            with lock:
                spent[key].append(ms)
                if key == "index":
                    spent["index_rows"] += args[1].message_count
            return out
        return call

    for (owner, m, key), orig in zip(patched, origs):
        setattr(owner, m, timed(orig, key))
    try:
        yield spent
    finally:
        for (owner, m, _), orig in zip(patched, origs):
            setattr(owner, m, orig)


class TimedCompletion:
    """A completion client that passes every call on and notes, per
    segment, the host-clock time of the first segment_consumed and of the
    first COMMIT answer to each instance (the elections)."""

    def __init__(self, client):
        self.client = client
        self.first_vote, self.commits = {}, {}

    def segment_consumed(self, table, segment, instance, offset):
        t = time.perf_counter()
        self.first_vote.setdefault(segment, t)
        resp = self.client.segment_consumed(table, segment, instance, offset)
        if resp.status == "COMMIT":
            self.commits.setdefault((segment, instance), time.perf_counter())
        return resp

    def __getattr__(self, name):
        return getattr(self.client, name)


def _await_ingest(pred, what: str, timeout_s: float = INGEST_WAIT_S) -> float:
    """Wait for pred(); the host seconds it took. Fails after timeout_s."""
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"ingest: {what} not reached in "
                                 f"{timeout_s} s")
        time.sleep(0.005)
    return time.perf_counter() - t0


def topic_columns(registry, topic: str, names) -> tuple:
    """(columns of every row the topic holds, read back partition by
    partition, rows per partition): the oracle's input."""
    t = registry.topic(topic)
    with t.lock:
        parts = [list(p) for p in t.partitions]
    cols = {}
    for c in names:
        vals = [m.value[c] for p in parts for m in p]
        cols[c] = (np.asarray(vals, dtype=object) if c == "s_region"
                   else np.asarray(vals, dtype=np.int64))
    return cols, [len(p) for p in parts]


def _publish(registry, topic: str, cols: dict, lo: int, hi: int,
             key: str = "lo_orderkey") -> None:
    """Rows lo..hi of the generated columns as row dicts, in batches of
    INGEST_BATCH (a million row dicts at once would cost gigabytes)."""
    names = list(cols)
    for a in range(lo, hi, INGEST_BATCH):
        b = min(hi, a + INGEST_BATCH)
        batch = [dict(zip(names, r)) for r in zip(
            *[cols[c][a:b].tolist() for c in names])]
        registry.publish(topic, batch, partition_key=key)


def _retired_names_gone(names) -> None:
    """No plane set in REALTIME_PLANES and nothing in any live executor's
    device cache under the names of sealed consuming segments (called
    before any query touched their immutable replacements)."""
    from pinot_tpu_torch.realtime.device_plane import REALTIME_PLANES
    from pinot_tpu_torch.segment.device_cache import live_caches

    left = set(names) & REALTIME_PLANES.names()
    for cache in live_caches():
        left |= set(names) & cache.segment_names()
    if left:
        raise AssertionError(f"ingest: sealed segments {sorted(left)} still "
                             "hold device state after their commit")


class _IngestRun:
    """The phase's counted queries: each one's counts set to 0 just before
    it and read just after, its rows held against the oracle; the phase
    sums the launches."""

    def __init__(self, torch, interp):
        self.torch, self.interp = torch, interp
        from pinot_tpu_torch.ops import _cuda

        self._cuda = _cuda
        self.launches = {k: 0 for k in _cuda.LAUNCHES}

    def query(self, qe, qname, want, sql=None):
        _cuda, torch = self._cuda, self.torch
        from pinot_tpu_torch.realtime import device_plane

        _cuda.reset_launches()
        device_plane.reset_realtime_stats()
        fetch0 = self.interp.host_fetches()
        resident = qe.executor.cache.bytes_used()
        t0 = time.perf_counter()
        resp = qe.execute_sql(sql or INGEST_QUERIES[qname])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = sorted(tuple(r) for r in resp.result_table.rows)
        if got != sorted(tuple(r) for r in want):
            raise AssertionError(f"ingest {qname}: {len(got)} rows differ "
                                 f"from the oracle's {len(want)}")
        fetches = self.interp.host_fetches() - fetch0
        if fetches != 1:
            raise AssertionError(f"ingest {qname}: {fetches} host fetches")
        for k, v in _cuda.LAUNCHES.items():
            self.launches[k] += v
        st = device_plane.realtime_stats()
        return {"ms": ms, "launches": dict(_cuda.LAUNCHES),
                "device_dispatches": resp.num_device_dispatches,
                "uploaded_bytes": qe.executor.cache.bytes_used() - resident
                + st["deltaBytes"], "delta_bytes": st["deltaBytes"]}

    def warm_p50(self, qe, qname, iters) -> float:
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            qe.execute_sql(INGEST_QUERIES[qname])
            self.torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))


def _record_kernels(qe, qname, mxu, fg, torch, counted: dict,
                    sql=None) -> list:
    """One more run of the query with each kernel launch's inputs recorded,
    each with the live rows of the segments its dispatch covers; each
    launch held against its plain version, and the launches equal to the
    counted run's (`counted`). [(name, inputs, live, err, launches)]."""
    with dispatch_rows(qe.executor) as rows, \
            recording(mxu, "limb_sums", rows) as a_calls, \
            recording(fg, "fused_limb_sums", rows) as b_calls:
        qe.execute_sql(sql or INGEST_QUERIES[qname])
    made = {"limb_sums": len(a_calls), "fused_limb_sums": len(b_calls)}
    if made != {k: counted[k] for k in made}:
        raise AssertionError(f"ingest {qname}: the recording run made "
                             f"{made} calls, the counted run {counted}")
    out = []
    for name, calls, kernel, plain in (
            ("limb_sums", a_calls, mxu.limb_sums, mxu.limb_sums_plain),
            ("fused_limb_sums", b_calls, fg.fused_limb_sums,
             fg.fused_limb_sums_plain)):
        for k, (rec, live) in enumerate(calls):
            err = check_equal(torch, f"{name} ingest {qname} launch {k}",
                              kernel(*rec), plain(*rec))
            out.append((name, rec, live, err))
    return out


def _retired(managers) -> dict:
    """The managers' retirement counts, summed."""
    out = {"segments": 0, "bytesFreed": 0, "errors": 0}
    for m in managers:
        for k, v in m.retirement_stats().items():
            out[k] += v
    return out


def _kill_controller(live: dict, store, cid: str) -> None:
    """Crash-death of a controller, as the JAX package's soak test kills
    one: gone from the resolver, its session expired (the seat frees)."""
    c = live.pop(cid)
    c.leader.disconnect()
    store.expire_session(cid)
    c.leader.stop()


def phase_ingest(args, torch, qe, interp, mxu, fg, tmp, card) -> dict:
    """Realtime ingestion through the port's managers on the card: (1)
    `ingest` from a 2-partition topic: settle (2 committed segments of
    INGEST_FLUSH_ROWS, kernel A over their family; the consuming snapshots),
    freshness of a trickle, force_commit, a restart from the checkpoints
    with nothing consumed twice; (2) two replicas through the leader
    controller: one election and download, a leaderless window the
    consumers hold through, a committer that dies before commit_end
    replaced after its lease; (3) an upsert table through the manager.
    Every query's rows against a numpy oracle over the rows read back from
    the topic; every sealed segment's device state retired on commit."""
    from pinot_tpu_torch.cluster.controller import ClusterController
    from pinot_tpu_torch.cluster.store import PropertyStore
    from pinot_tpu_torch.engine.query_executor import QueryExecutor
    from pinot_tpu_torch.plugins.stream import kafka as kafka_plugin
    from pinot_tpu_torch.realtime import manager as rtm
    from pinot_tpu_torch.realtime.completion import LeaderCompletionClient
    from pinot_tpu_torch.spi.data_types import Schema
    from pinot_tpu_torch.spi.metrics import SERVER_METRICS, ServerMeter
    from pinot_tpu_torch.spi.stream import GLOBAL_STREAM_REGISTRY as reg
    from pinot_tpu_torch.spi.table_config import (IndexingConfig,
                                                  IngestionConfig,
                                                  TableConfig, TableType,
                                                  UpsertConfig)

    t_phase = time.perf_counter()
    run = _IngestRun(torch, interp)
    oracle_cols = ("d_year", "p_brand", "s_region", "lo_discount",
                   "lo_quantity", "lo_extendedprice", "lo_revenue")

    def config(name, topic, flush, stream="inmemory", **kw):
        streams = {"streamType": stream,
                   f"stream.{stream}.topic.name": topic,
                   "realtime.segment.flush.threshold.rows": flush}
        if stream == "kafka":
            streams["stream.kafka.broker.list"] = "memkafka:9092"
        return TableConfig(
            table_name=name, table_type=TableType.REALTIME,
            indexing=IndexingConfig(no_dictionary_columns=kw.pop(
                "raw", RAW_COLUMNS)),
            ingestion=IngestionConfig(stream_configs=streams), **kw)

    def oracle(topic, source=reg):
        cols, per_partition = topic_columns(source, topic, oracle_cols)
        return rt_expected([rt_partials(cols)]), per_partition

    def state_ok(mgrs):
        for m in mgrs:
            with m._lock:
                states = [c.state for c in m._consuming.values()]
            if "ERROR" in states:
                raise AssertionError(f"ingest: a consumer of "
                                     f"{m.instance_id} is in ERROR")

    schema = Schema.build(INGEST_TABLE, dimensions=SCHEMA_DIMS,
                          metrics=SCHEMA_METRICS)
    out = {"phase": "ingest", "card": card}
    recs = {}
    started, controllers = [], []
    # cell (1) reads through the Kafka plugin, over the in-process MemKafka
    kafka = MemKafka()
    factory = kafka_plugin.KafkaStreamConsumerFactory
    saved_client = factory.__dict__["client_factory"]
    factory.client_factory = staticmethod(
        lambda config: (kafka.consumer(), kafka_plugin.TopicPartition))
    with ingest_timers() as spent:
        try:
            # -- (1) one replica, INGEST_PARTITIONS partitions -------------
            topic = "ingest_lineorder"
            kafka.create_topic(topic, num_partitions=INGEST_PARTITIONS)
            total = INGEST_PARTITIONS * INGEST_ROWS
            cols = gen_ssb(total + INGEST_TRICKLE, args.seed + 6)
            cfg = config(INGEST_TABLE, topic, INGEST_FLUSH_ROWS,
                         stream="kafka")
            data_dir = f"{tmp}/{INGEST_TABLE}"
            mgr = rtm.RealtimeTableDataManager(schema, cfg, data_dir)
            started.append(mgr)
            qe.add_table(schema, mgr.segments, INGEST_TABLE)
            t0 = time.perf_counter()
            mgr.start()
            # this thread is the producer, publishing while the consumer
            # threads run
            _publish(kafka, topic, cols, 0, total)
            t_last = time.perf_counter()
            publish_s = t_last - t0
            _await_ingest(lambda: mgr.total_docs() == total
                          and len(mgr._committed) == INGEST_PARTITIONS,
                          "the 2-partition settle point")
            consumed_s = time.perf_counter() - t0
            drain_ms = (time.perf_counter() - t_last) * 1e3
            state_ok([mgr])
            sealed = list(mgr._segment_names)
            _retired_names_gone(sealed)
            want, per_partition = oracle(topic, kafka)
            one = {"stream": "kafka (MemKafka through the Kafka plugin)",
                   "rows": total, "rows_per_partition": per_partition,
                   "publish_s": publish_s, "consume_s": consumed_s,
                   "rows_per_s": total / consumed_s,
                   "drain_ms_after_last_publish": drain_ms,
                   "committed_docs": [s.num_docs for s in mgr._committed],
                   "queries": {}}
            if not all(INGEST_FLUSH_ROWS <= n < INGEST_FLUSH_ROWS + 1000
                       for n in one["committed_docs"]):
                raise AssertionError(f"ingest: committed {one['committed_docs']}")
            for qname in ("rt_q1", "rt_q2", "rt_range"):
                one["queries"][qname] = run.query(qe, qname, want[qname])
            one["warm_p50_ms"] = {q: run.warm_p50(qe, q, args.iters)
                                  for q in ("rt_q2", "rt_range")}
            counted = one["queries"]["rt_q2"]["launches"]
            recs["rt_q2"] = (_record_kernels(qe, "rt_q2", mxu, fg, torch,
                                             counted), counted)
            # freshness: a trickle of rows after the settle point, timed
            # from its publish to the first query that counts it
            count_sql = f"SELECT COUNT(*) FROM {INGEST_TABLE}"
            t0 = time.perf_counter()
            _publish(kafka, topic, cols, total, total + INGEST_TRICKLE)
            polls = 0
            while True:
                polls += 1
                n = qe.execute_sql(count_sql).result_table.rows[0][0]
                if n == total + INGEST_TRICKLE:
                    break
                if time.perf_counter() - t0 > INGEST_WAIT_S:
                    raise AssertionError(f"ingest: trickle unseen ({n})")
            one["freshness_ms"] = (time.perf_counter() - t0) * 1e3
            one["freshness_polls"] = polls
            total += INGEST_TRICKLE
            del cols
            want, per_partition = oracle(topic, kafka)
            for qname in ("rt_q1", "rt_q2", "rt_range"):
                run.query(qe, qname, want[qname])  # the snapshots' planes
            retired0 = mgr.retirement_stats()
            t0 = time.perf_counter()
            forced = mgr.force_commit(timeout=INGEST_WAIT_S)
            one["force_commit_ms"] = (time.perf_counter() - t0) * 1e3
            _await_ingest(lambda: mgr.retirement_stats()["segments"]
                          == retired0["segments"] + len(forced),
                          "the forced commits' retirement")
            state_ok([mgr])
            _retired_names_gone(forced)
            one["forced"] = {"segments": len(forced), "bytes_freed":
                             mgr.retirement_stats()["bytesFreed"]
                             - retired0["bytesFreed"]}
            if len(forced) != INGEST_PARTITIONS or \
                    one["forced"]["bytes_freed"] <= 0:
                raise AssertionError(f"ingest: force_commit {one['forced']}")
            one["after_commit"] = {q: run.query(qe, q, want[q])
                                   for q in ("rt_q2", "rt_range")}
            # restart from the checkpoints: the committed segments load in
            # commit order, nothing is consumed again
            names = list(mgr._segment_names)
            cp = json.loads(open(f"{data_dir}/_checkpoints.json").read())
            if [int(cp["partitions"][str(p)]) for p in range(
                    INGEST_PARTITIONS)] != per_partition:
                raise AssertionError(f"ingest: checkpoint {cp['partitions']} "
                                     f"against the topic's {per_partition}")
            mgr.stop()
            for seg in mgr._committed:
                qe.executor.cache.drop(seg)
            t0 = time.perf_counter()
            mgr = rtm.RealtimeTableDataManager(schema, cfg, data_dir)
            started.append(mgr)
            qe.add_table(schema, mgr.segments, INGEST_TABLE)
            mgr.start()
            one["restart_ms"] = (time.perf_counter() - t0) * 1e3
            time.sleep(0.2)  # a re-consume would show in rows_indexed
            again = sum(m.rows_indexed for m in mgr._consuming.values())
            if ([s.name for s in mgr._committed] != names
                    or mgr.total_docs() != total or again):
                raise AssertionError(
                    f"ingest restart: {mgr.total_docs()} docs, {again} "
                    f"consumed again, order {mgr._segment_names}")
            one["restart"] = run.query(qe, "rt_q2", want["rt_q2"])
            mgr.stop()
            for seg in mgr._committed:
                qe.executor.cache.drop(seg)
            del qe.tables[INGEST_TABLE]
            kafka.delete_topic(topic)
            one["feed_us_per_row"] = sum(spent["index"]) * 1e3 / max(
                1, spent["index_rows"])
            cell_index = (sum(spent["index"]), spent["index_rows"])
            out["partitions"] = one

            # -- (2) two replicas through the leader controller -----------
            topic = "ingest_replicas"
            reg.create_topic(topic, num_partitions=1)
            n_rows = REPLICA_FLUSH_ROWS + 2 * REPLICA_TAIL
            cols = gen_ssb(n_rows, args.seed + 7)
            store = PropertyStore()
            live = {cid: ClusterController(store, instance_id=cid,
                                           completion_config=REPLICA_COMPLETION)
                    for cid in ("Ctrl_0", "Ctrl_1")}
            controllers = list(live.values())
            client = TimedCompletion(LeaderCompletionClient(store, live.get))
            die = {"armed": False, "fired": None}

            def die_once(m):
                if die["armed"] and die["fired"] is None:
                    die["fired"] = (m.instance_id, time.perf_counter())
                    return True
                return False

            rcfg = config(INGEST_TABLE, topic, REPLICA_FLUSH_ROWS)
            mgrs, qes = {}, {}
            for inst in ("A", "B"):
                mgrs[inst] = rtm.RealtimeTableDataManager(
                    schema, rcfg, f"{tmp}/{INGEST_TABLE}_{inst}",
                    completion=client, instance_id=inst,
                    test_hooks={"die_before_commit_end": die_once})
                started.append(mgrs[inst])
                qes[inst] = QueryExecutor(device=DEVICE)
                qes[inst].add_table(schema, mgrs[inst].segments, INGEST_TABLE)
            t0 = time.perf_counter()
            for m in mgrs.values():
                m.start()
            _publish(reg, topic, cols, 0, REPLICA_FLUSH_ROWS + REPLICA_TAIL)
            _await_ingest(lambda: all(
                m.total_docs() == REPLICA_FLUSH_ROWS + REPLICA_TAIL
                and len(m._committed) == 1 for m in mgrs.values()),
                "the replicas' first commit")
            two = {"consume_s": time.perf_counter() - t0}
            two["rows_per_s_per_replica"] = (REPLICA_FLUSH_ROWS
                                             + REPLICA_TAIL) / two["consume_s"]
            state_ok(mgrs.values())
            done = store.children(f"/SEGMENTS/{INGEST_TABLE}")
            names = {i: list(m._segment_names) for i, m in mgrs.items()}
            if len(done) != 1 or names["A"] != names["B"] != done:
                raise AssertionError(f"ingest replicas: DONE {done}, {names}")
            seg0 = done[0]
            rec = store.get(f"/SEGMENTS/{INGEST_TABLE}/{seg0}")
            winner = rec["committer"]
            loser = "B" if winner == "A" else "A"
            own = f"{tmp}/{INGEST_TABLE}_{loser}/{seg0}"
            if rec["location"] == own or not os.path.isdir(own):
                raise AssertionError(f"ingest replicas: {loser} did not "
                                     f"download {seg0} into its directory")
            two["election_ms"] = (client.commits[(seg0, winner)]
                                  - client.first_vote[seg0]) * 1e3
            two["download_ms"] = list(spent["download"])
            _retired_names_gone([seg0])
            want, _ = oracle(topic)
            two["queries"] = {}
            for inst in ("A", "B"):
                two["queries"][inst] = run.query(qes[inst], "rt_q2",
                                                 want["rt_q2"])
            counted = two["queries"][winner]["launches"]
            recs["rt_q2_replica"] = (_record_kernels(
                qes[winner], "rt_q2", mxu, fg, torch, counted), counted)

            # a leaderless window: both controllers die; the consumers
            # hold (COMPLETION_HOLDS_NO_LEADER), never ERROR, and commit
            # once a controller is back
            for cid in list(live):
                _kill_controller(live, store, cid)
            holds0 = SERVER_METRICS.meter_count(
                ServerMeter.COMPLETION_HOLDS_NO_LEADER)
            retired0 = _retired(mgrs.values())
            for m in mgrs.values():
                with m._lock:
                    consuming = list(m._consuming.values())
                for c in consuming:
                    c.force_commit()
            _await_ingest(lambda: SERVER_METRICS.meter_count(
                ServerMeter.COMPLETION_HOLDS_NO_LEADER) > holds0,
                "a hold without a leader")
            time.sleep(0.5)
            if len(store.children(f"/SEGMENTS/{INGEST_TABLE}")) != 1:
                raise AssertionError("ingest: a commit without a leader")
            state_ok(mgrs.values())
            two["holds_no_leader"] = SERVER_METRICS.meter_count(
                ServerMeter.COMPLETION_HOLDS_NO_LEADER) - holds0
            t0 = time.perf_counter()
            live["Ctrl_0"] = ClusterController(
                store, instance_id="Ctrl_0",
                completion_config=REPLICA_COMPLETION)
            controllers.append(live["Ctrl_0"])
            _await_ingest(lambda: all(len(m._committed) == 2
                                      for m in mgrs.values())
                          and _retired(mgrs.values())["segments"]
                          == retired0["segments"] + 2,
                          "the commit after the leaderless window")
            two["commit_after_leader_ms"] = (time.perf_counter() - t0) * 1e3
            done = store.children(f"/SEGMENTS/{INGEST_TABLE}")
            names = {i: list(m._segment_names) for i, m in mgrs.items()}
            if len(done) != 2 or names["A"] != names["B"]:
                raise AssertionError(f"ingest leaderless: {done}, {names}")
            _retired_names_gone([names["A"][1]])
            two["bytes_freed_leaderless_commit"] = (
                _retired(mgrs.values())["bytesFreed"]
                - retired0["bytesFreed"])
            if two["bytes_freed_leaderless_commit"] <= 0:
                raise AssertionError("ingest: the sealed snapshots' planes "
                                     "were not freed")

            # a committer that dies between its build and commit_end: the
            # other replica is re-elected once the lease is over
            _publish(reg, topic, cols, REPLICA_FLUSH_ROWS + REPLICA_TAIL,
                     n_rows)
            _await_ingest(lambda: all(m.total_docs() == n_rows
                                      for m in mgrs.values()),
                          "the replicas' tail")
            want, _ = oracle(topic)
            die["armed"] = True
            for m in mgrs.values():
                with m._lock:
                    consuming = list(m._consuming.values())
                for c in consuming:
                    c.force_commit()
            _await_ingest(lambda: len(store.children(
                f"/SEGMENTS/{INGEST_TABLE}")) == 3,
                "the re-elected commit")
            dead = die["fired"][0]
            survivor = "B" if dead == "A" else "A"
            _await_ingest(lambda: len(mgrs[survivor]._committed) == 3,
                          "the survivor's third segment")
            seg2 = mgrs[survivor]._segment_names[2]
            rec = store.get(f"/SEGMENTS/{INGEST_TABLE}/{seg2}")
            if (rec["committer"] != survivor
                    or mgrs[survivor]._committed[2].num_docs != REPLICA_TAIL):
                raise AssertionError(f"ingest crash: {rec}")
            two["reelection_ms"] = (client.commits[(seg2, survivor)]
                                    - die["fired"][1]) * 1e3
            state_ok(mgrs.values())
            two["crash"] = run.query(qes[survivor], "rt_q2", want["rt_q2"])
            two["done_records"] = len(store.children(
                f"/SEGMENTS/{INGEST_TABLE}"))
            for m in mgrs.values():
                m.stop()
            for c in controllers:
                c.stop()
            reg.delete_topic(topic)
            del qes, cols
            out["replicas"] = two

            # -- (3) an upsert table through the manager ------------------
            topic = "ingest_upsert"
            reg.create_topic(topic, num_partitions=1)
            ucols = gen_ssb(UPS_INGEST_ROWS, args.seed + 8)
            ucols["pk"] = np.random.default_rng(args.seed + 9).integers(
                0, UPS_INGEST_KEYS, UPS_INGEST_ROWS)
            ts = np.arange(UPS_INGEST_ROWS, dtype=np.int64)
            stale = np.arange(UPS_INGEST_ROWS) % UPS_STALE_EVERY \
                == UPS_STALE_EVERY - 1
            ts[stale] = -1 - ts[stale]
            ucols["ts"] = ts
            uschema = Schema.build(UPS_INGEST_TABLE,
                                   dimensions=SCHEMA_DIMS + [("pk", "LONG")],
                                   metrics=SCHEMA_METRICS,
                                   date_times=[("ts", "LONG")],
                                   primary_key_columns=["pk"])
            ucfg = config(UPS_INGEST_TABLE, topic, UPS_INGEST_FLUSH,
                          raw=RAW_COLUMNS + ["pk", "ts"],
                          upsert=UpsertConfig(mode="FULL",
                                              comparison_columns=["ts"]))
            umgr = rtm.RealtimeTableDataManager(
                uschema, ucfg, f"{tmp}/{UPS_INGEST_TABLE}")
            started.append(umgr)
            qe.add_table(uschema, umgr.segments, UPS_INGEST_TABLE)
            t0 = time.perf_counter()
            umgr.start()
            _publish(reg, topic, ucols, 0, UPS_INGEST_ROWS, key="pk")
            n_commits = UPS_INGEST_ROWS // UPS_INGEST_FLUSH
            _await_ingest(lambda: umgr.total_docs() == UPS_INGEST_ROWS
                          and len(umgr._committed) == n_commits,
                          "the upsert table's settle point")
            three = {"consume_s": time.perf_counter() - t0}
            three["rows_per_s"] = UPS_INGEST_ROWS / three["consume_s"]
            state_ok([umgr])
            _retired_names_gone(umgr._segment_names)
            rcols, _ = topic_columns(reg, topic, (
                "pk", "ts", "s_region", "d_year", "lo_revenue"))
            want_ups = ups_expected(rcols, rcols["pk"], rcols["ts"])
            three["query"] = run.query(qe, "ups", want_ups)
            three["primary_keys"] = umgr.pk_manager.num_primary_keys()
            counted = three["query"]["launches"]
            recs["ups"] = (_record_kernels(qe, "ups", mxu, fg, torch,
                                           counted), counted)
            umgr.stop()
            for seg in umgr._committed:
                qe.executor.cache.drop(seg)
            del qe.tables[UPS_INGEST_TABLE]
            reg.delete_topic(topic)
            del ucols, rcols
            out["upsert"] = three
        finally:
            factory.client_factory = saved_client
            for m in started:
                m.stop()
            for c in controllers:
                c.stop()
    retired = _retired(started)
    if retired["errors"]:
        raise AssertionError(f"ingest: {retired['errors']} retirements "
                             "raised")
    for k in run.launches:
        if run.launches[k] == 0:
            raise AssertionError(f"the ingest phase never launched {k}")
    index_ms = sum(spent["index"])
    out.update({
        "launches": run.launches, "retired": retired,
        "feed_us_per_row": index_ms * 1e3 / max(1, spent["index_rows"]),
        # the in-memory topics' cells (2) and (3), beside cell (1)'s Kafka
        "inmemory_feed_us_per_row": (index_ms - cell_index[0]) * 1e3 / max(
            1, spent["index_rows"] - cell_index[1]),
        "rows_through_managers": spent["index_rows"],
        "build_ms": spent["build"], "load_ms": spent["load"],
        "seconds": time.perf_counter() - t_phase})
    emit(out)
    gc.collect()
    return recs


def _rows_equal(qname, resp, want, ordered) -> None:
    got = [tuple(r) for r in resp.result_table.rows]
    want = [tuple(r) for r in want]
    if not ordered:
        got, want = sorted(got), sorted(want)
    if got != want:
        bad = next((a, b) for a, b in zip(got + [None] * len(want),
                                          want + [None] * len(got))
                   if a != b)
        raise AssertionError(f"cache {qname}: {len(got)} rows vs oracle "
                             f"{len(want)}; first difference {bad}")


def _cache_run(torch, qe, interp, sql):
    """One run with its counts set to 0 just before it: (response, ms,
    record)."""
    from pinot_tpu_torch.ops import _cuda

    _cuda.reset_launches()
    fetch0 = interp.host_fetches()
    resident = qe.executor.cache.bytes_used()
    with recording(interp, "combine_sparse_group_tables") as merged:
        t0 = time.perf_counter()
        resp = qe.execute_sql(sql)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    if resp.exceptions:
        raise AssertionError(f"cache: {resp.exceptions}")
    return resp, ms, {
        "hits": resp.num_segments_cache_hit,
        "misses": resp.num_segments_cache_miss,
        "cache_outcome": resp.cache_outcome,
        "device_dispatches": resp.num_device_dispatches,
        "host_fetches": interp.host_fetches() - fetch0,
        "device_combines": len(merged),
        "launches": {k: v for k, v in _cuda.LAUNCHES.items() if v},
        "uploaded_bytes": qe.executor.cache.bytes_used() - resident}


def phase_cache(args, torch, qe, expected, interp, state, card) -> dict:
    """The caches on (PINOT_TPU_SEGMENT_CACHE=1, PINOT_TPU_RESULT_CACHE=1
    around this phase, both cleared first). Per case: the cold run, the
    warm run's counts (hits, misses, device dispatches, host fetches,
    launches), the warm p50 cached and with the cache opted out by SET, and
    every run's rows against the oracle (a hit's rows equal the
    recompute's). q2_family: a full hit; q3: the merged sparse table, then
    the device tier alone; a partial overlap of q2_family's family (one
    member cached, the other three a new family of three); rt_q2 after one
    more generation (the committed segments hit, the snapshot dispatches
    kernel B); ups after overwrites of committed keys (the committed
    segment misses: its validity plane is in the key), with the
    fingerprint's time; q8 and mse_agg through the result cache, and
    mse_agg's leaf through the partial cache with the result cache off.
    Returns the oracle rows of the realtime queries at their new state."""
    import pinot_tpu_torch.engine.query_executor as qx
    from pinot_tpu_torch.cache.keys import program_fingerprint
    from pinot_tpu_torch.cache.partial import GLOBAL_PARTIAL_CACHE
    from pinot_tpu_torch.realtime import device_plane

    t_phase = time.perf_counter()
    os.environ["PINOT_TPU_SEGMENT_CACHE"] = "1"
    os.environ["PINOT_TPU_RESULT_CACHE"] = "1"
    dcache, rcache = qe.executor.cache, qe.multistage.result_cache

    def clear():
        GLOBAL_PARTIAL_CACHE.clear()
        dcache.drop_partials()
        rcache.clear()

    clear()
    cases, slow = {}, SLOW_QUERY_MS

    def case(name, sql, want, ordered, opt_out, warm_expect):
        rec = {}
        resp, rec["cold_ms"], rec["cold"] = _cache_run(torch, qe, interp, sql)
        _rows_equal(name, resp, want, ordered)
        cold_rows = resp.result_table.rows
        resp, _, rec["warm"] = _cache_run(torch, qe, interp, sql)
        _rows_equal(name, resp, want, ordered)
        for k, v in warm_expect.items():
            if rec["warm"][k] != v:
                raise AssertionError(f"cache {name}: warm {k} "
                                     f"{rec['warm'][k]}, want {v}")
        for label, q in (("warm_p50_ms", sql),
                         ("opted_out_p50_ms", opt_out + sql)):
            ts = []
            while len(ts) < (1 if ts and ts[0] > slow else args.iters):
                r, ms, _ = _cache_run(torch, qe, interp, q)
                ts.append(ms)
            if r.result_table.rows != cold_rows:
                raise AssertionError(f"cache {name}: {label} rows differ "
                                     "from the cold run's")
            rec[label] = float(np.median(ts))
            rec[label[:-len("_p50_ms")] + "_runs"] = len(ts)
        cases[name] = rec
        return rec

    seg_off, res_off = "SET segmentCache = false; ", "SET resultCache = false; "
    full_hit = {"device_dispatches": 0, "host_fetches": 0}
    case("q2_family", QUERIES["q2_family"], expected["q2_family"], False,
         seg_off, {**full_hit, "hits": 4, "misses": 0})
    # a partial overlap: one member cached, three dispatch as a new family
    names = [s.name for s in qe.tables["ssb"].segments]
    for n in names[1:]:
        GLOBAL_PARTIAL_CACHE.invalidate_segment(n)
    stacks0 = dcache.stats()["stackBytes"]
    resp, ms, rec = _cache_run(torch, qe, interp, QUERIES["q2_family"])
    _rows_equal("q2_family", resp, expected["q2_family"], False)
    if (rec["hits"], rec["misses"], rec["device_dispatches"]) != (1, 3, 1):
        raise AssertionError(f"cache q2_family overlap: {rec}")
    rec.update(ms=ms, new_stack_bytes=dcache.stats()["stackBytes"] - stacks0)
    cases["q2_family_overlap_3_of_4"] = rec

    # the merged table may not fit the partial budget: then the warm run is
    # served by the device tier (no dispatch, the device combine, a fetch)
    rec = case("q3", QUERIES["q3"], expected["q3"], True, seg_off,
               {"device_dispatches": 0, "hits": 4})
    rec["partial_cache"] = GLOBAL_PARTIAL_CACHE.stats()
    rec["merged_fits_budget"] = any(k[0] == "sparse_merged" for k in
                                    GLOBAL_PARTIAL_CACHE._entries)
    GLOBAL_PARTIAL_CACHE.clear()
    resp, rec["device_tier_ms"], rec["device_tier"] = _cache_run(
        torch, qe, interp, QUERIES["q3"])
    _rows_equal("q3", resp, expected["q3"], True)
    if (rec["device_tier"]["device_dispatches"],
            rec["device_tier"]["device_combines"],
            rec["device_tier"]["hits"]) != (0, 1, 4):
        raise AssertionError(f"cache q3 device tier: {rec['device_tier']}")
    rec["device_partials"] = dcache.stats()
    if not all(t.device.type == dcache.device.type
               for ent in dcache._partials.values() for t in ent[0]):
        raise AssertionError("cache q3: a device-tier table left the card")

    # rt_q2: cold and warm at the realtime phase's final state, then one
    # more generation: the 4 committed segments hit, the snapshot misses
    want = rt_expected(state["live_parts"])
    case("rt_q2", RT_QUERIES["rt_q2"], want["rt_q2"], False, seg_off,
         {**full_hit, "hits": 5})
    extra = gen_ssb(RT_NEXT_GENERATION, args.seed + 6)
    live, cnames = state["live"], list(extra)
    for row in zip(*[extra[c].tolist() for c in cnames]):
        live.index(dict(zip(cnames, row)))
    state["live_parts"].append(rt_partials(extra))
    want = rt_expected(state["live_parts"])
    device_plane.reset_realtime_stats()
    resp, ms, rec = _cache_run(torch, qe, interp, RT_QUERIES["rt_q2"])
    _rows_equal("rt_q2", resp, want["rt_q2"], False)
    if (rec["hits"], rec["misses"], rec["device_dispatches"],
            rec["launches"].get("fused_limb_sums")) != (4, 1, 1, 1):
        raise AssertionError(f"cache rt_q2 next generation: {rec}")
    rec.update(ms=ms, rows_added=RT_NEXT_GENERATION,
               delta_bytes=device_plane.realtime_stats()["deltaBytes"])
    cases["rt_q2_next_generation"] = rec

    # ups: overwrite keys of the committed segment; its key changes
    mgr, consuming = state["ups_mgr"], state["ups_consuming"]
    ucols = state["ups_cols"]
    case("ups", RT_QUERIES["ups"], ups_expected(
        ucols, ucols["pk"], ucols["ts"]), False, seg_off,
        {**full_hit, "hits": 2})
    over = gen_ssb(UPS_CACHE_OVERWRITE, args.seed + 7)
    rng = np.random.default_rng(args.seed + 8)
    over["pk"] = ucols["pk"][rng.integers(0, UPS_ROWS, UPS_CACHE_OVERWRITE)]
    over["ts"] = np.arange(UPS_CACHE_OVERWRITE, dtype=np.int64) + \
        int(ucols["ts"].max()) + 1
    onames = list(over)
    for row in zip(*[over[c].tolist() for c in onames]):
        r = dict(zip(onames, row))
        mgr.add_record(consuming, consuming.index(r), r)
    ucols = {c: np.concatenate([ucols[c], over[c]]) for c in ucols}
    fp_ms = []

    def timed_fp(plan, query):
        t0 = time.perf_counter()
        out = program_fingerprint(plan, query)
        fp_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    qx.program_fingerprint = timed_fp
    try:
        resp, ms, rec = _cache_run(torch, qe, interp, RT_QUERIES["ups"])
    finally:
        qx.program_fingerprint = program_fingerprint
    _rows_equal("ups", resp, ups_expected(ucols, ucols["pk"], ucols["ts"]),
                False)
    if (rec["hits"], rec["misses"]) != (0, 2):
        raise AssertionError(f"cache ups after overwrite: {rec}")
    rec.update(ms=ms, overwrites=UPS_CACHE_OVERWRITE,
               fingerprint_ms=fp_ms,
               validity_rows=state["ups_committed"].num_docs)
    cases["ups_after_overwrite"] = rec

    # the multi-stage result cache, and the leaf's partial cache
    for qname in ("q8", "mse_agg"):
        case(qname, MSE_QUERIES[qname], expected[qname], qname != "mse_agg",
             res_off, {"device_dispatches": 0, "cache_outcome": "hit"})
    sql = res_off + MSE_QUERIES["mse_agg"]
    resp, ms, rec = _cache_run(torch, qe, interp, sql)
    _rows_equal("mse_agg", resp, expected["mse_agg"], False)
    # (an MSE response carries no segment counts: no dispatch, no result
    # cache, so the leaf was served by the partial cache)
    if rec["device_dispatches"] != 0 or rec["cache_outcome"]:
        raise AssertionError(f"cache mse_agg leaf: {rec}")
    rec["ms"] = ms
    cases["mse_agg_leaf_partial_hit"] = rec
    stats = {"partial_cache": GLOBAL_PARTIAL_CACHE.stats(),
             "device_cache": dcache.stats(), "result_cache": rcache.stats()}
    clear()
    os.environ["PINOT_TPU_SEGMENT_CACHE"] = "0"
    os.environ["PINOT_TPU_RESULT_CACHE"] = "0"
    emit({"phase": "cache", "card": card, "oracle": "equal", "cases": cases,
          "stats": stats, "seconds": time.perf_counter() - t_phase})
    final = rt_expected(state["live_parts"])
    final["ups"] = ups_expected(ucols, ucols["pk"], ucols["ts"])
    return final


def fill_free_blocks(torch) -> list:
    """Tensors that take the caching allocator's free blocks under the
    current cap, largest chunks first: blocks freed inside segments that
    still hold live tensors are not released by empty_cache, and a query
    could run in them whatever the cap."""
    ballast = []
    for size in (64 << 20, 2 << 20, 512 << 10):
        while True:
            try:
                ballast.append(torch.empty(size, dtype=torch.uint8,
                                           device="cuda"))
            except torch.cuda.OutOfMemoryError:
                break
    return ballast


# -- coalescing and tracing ----------------------------------------------------

# client threads of phase `coalesce`; each runs COALESCE_ITERS queries in
# a closed loop (16 before phase `ingest` joined the run, 8 before phase
# `batch_ingest`, 4 before phase `timeseries`)
COALESCE_CLIENTS = (1, 2, 4, 8, 16)
COALESCE_ITERS = 2
COALESCE_WINDOW_MS = "2"
# the queries whose EXPLAIN rows on the card must equal the CPU executor's
EXPLAIN_QUERIES = ("q1", "q2", "q2_family", "q3", "q5", "sel_order",
                   "mv_group", "st_q2", "ix_text", "rt_q2")


def _q2_region(region: str) -> str:
    return QUERIES["q2_family"].replace("'ASIA'", f"'{region}'")


def _clients(qe, sqls, iters, barrier_rounds):
    """Run one client thread per SQL, each `iters` queries back to back
    (with `barrier_rounds`, all released together for every query):
    ([(sql, response, ms)], wall seconds)."""
    import threading

    barrier = threading.Barrier(len(sqls)) if barrier_rounds else None
    out: list = [[] for _ in sqls]
    errors: list = []

    def client(i, sql):
        try:
            for _ in range(iters):
                if barrier is not None:
                    barrier.wait(timeout=120)
                t0 = time.perf_counter()
                resp = qe.execute_sql(sql)
                out[i].append((sql, resp, (time.perf_counter() - t0) * 1e3))
        except Exception as e:  # raised below, on the main thread
            errors.append(e)
            if barrier is not None:
                barrier.abort()

    threads = [threading.Thread(target=client, args=(i, s))
               for i, s in enumerate(sqls)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return [r for rs in out for r in rs], wall


def phase_coalesce(torch, qe, expected, mxu, card) -> dict:
    """Cross-query coalescing (engine/coalesce.py) with both caches off:
    q2_family from 1, 2, 4, 8 and 16 client threads. First a structure
    round per count, the window long and the group closing when its N-th
    member joins: one dispatch for the N queries, every response saying
    num_coalesced_queries N - 1 (kernel A's inputs of the group recorded
    at N = 8 and 16: S*Q = 32 and 64 members). Then, per count, closed-loop
    clients with the window at COALESCE_WINDOW_MS and MAX_QUERIES = N, and
    with the window at 0: p50 and p99 ms, queries/s, rows/s, dispatches a
    query, groups formed and the [S*Q] bytes built; identical SQL (a
    dashboard refreshed by N viewers), and the region literal varied across
    clients (it rides as a param plane). Every response's rows equal the
    numpy oracle's."""
    from pinot_tpu_torch.engine.coalesce import FamilyTraffic, QueryCoalescer

    t_phase = time.perf_counter()
    table_rows = sum(s.num_docs for s in qe._table("ssb").segments)
    want = {QUERIES["q2_family"]: sorted(map(tuple, expected["q2"]))}
    for r in REGIONS:
        want[_q2_region(r)] = sorted(map(tuple, expected[f"q2/{r}"]))

    def check(runs):
        for sql, resp, _ in runs:
            if sorted(map(tuple, resp.result_table.rows)) != want[sql]:
                raise AssertionError(f"coalesce: rows differ from the "
                                     f"oracle for {sql}")

    saved = {k: os.environ.get(k) for k in ("PINOT_TPU_COALESCE_WINDOW_MS",
                                             "PINOT_TPU_COALESCE_MAX_QUERIES")}
    coalescer = qe.coalescer
    group_inputs, structure, timed = {}, {}, {}
    # the script's own heap (the oracle rows above all) made a full
    # collection take about 1 s, landing in about half of the timed runs:
    # the heap is frozen out of the collector for the phase, as a server
    # freezes its own after loading, and the pause it would cost is timed
    t0 = time.perf_counter()
    gc.collect()
    full_collect_ms = (time.perf_counter() - t0) * 1e3
    gc.freeze()
    frozen = gc.get_freeze_count()
    try:
        for n in COALESCE_CLIENTS:
            # structure: the group closes when full, never on the window
            # (a lone client has no peer to wait for)
            qe.coalescer = QueryCoalescer(FamilyTraffic(min_traffic=1.0))
            os.environ["PINOT_TPU_COALESCE_WINDOW_MS"] = \
                "60000" if n > 1 else "0"
            os.environ["PINOT_TPU_COALESCE_MAX_QUERIES"] = str(max(2, n))
            sql = QUERIES["q2_family"]
            with recording(mxu, "limb_sums") as calls:
                runs, _ = _clients(qe, [sql] * n, 1, True)
            torch.cuda.synchronize()
            check(runs)
            dispatches = sum(r.num_device_dispatches for _, r, _ in runs)
            peers = sorted({r.num_coalesced_queries for _, r, _ in runs})
            want_peers = [n - 1] if n > 1 else [0]
            if dispatches != 1 or peers != want_peers or len(calls) != 1:
                raise AssertionError(
                    f"coalesce: {n} clients made {dispatches} dispatches, "
                    f"{len(calls)} launches of kernel A, peers {peers}")
            if n in (8, 16):
                group_inputs[n] = calls[0]
            structure[n] = {"dispatches": dispatches, "launches": len(calls),
                            "num_coalesced_queries": peers[0],
                            "group_members": int(calls[0][0].shape[0])}
            # timed: closed-loop clients, with the window and without
            for traffic in ("identical", "mixed_literals"):
                sqls = ([sql] * n if traffic == "identical" else
                        [_q2_region(REGIONS[i % len(REGIONS)])
                         for i in range(n)])
                for window in (COALESCE_WINDOW_MS, "0"):
                    qe.coalescer = QueryCoalescer(
                        FamilyTraffic(min_traffic=1.0))
                    os.environ["PINOT_TPU_COALESCE_WINDOW_MS"] = window
                    os.environ["PINOT_TPU_COALESCE_MAX_QUERIES"] = str(
                        max(2, n))
                    rep0 = qe.executor.repeat_stats()
                    mem0, gc0 = torch.cuda.memory_stats(), gc.get_stats()[2]
                    runs, wall = _clients(qe, sqls, COALESCE_ITERS, False)
                    torch.cuda.synchronize()
                    check(runs)
                    rep = qe.executor.repeat_stats()
                    mem, gc2 = torch.cuda.memory_stats(), gc.get_stats()[2]
                    ms = [m for _, _, m in runs]
                    snap = qe.coalescer.snapshot()
                    timed[f"{traffic}/clients{n}/window{window}"] = {
                        "queries": len(runs),
                        "p50_ms": float(np.percentile(ms, 50)),
                        "p99_ms": float(np.percentile(ms, 99)),
                        "queries_per_s": len(runs) / wall,
                        "rows_per_s": len(runs) * table_rows / wall,
                        "dispatches_per_query": sum(
                            r.num_device_dispatches for _, r, _ in runs)
                        / len(runs),
                        "coalesced_peers_mean": float(np.mean(
                            [r.num_coalesced_queries for _, r, _ in runs])),
                        "coalesce_wait_ms_p50": float(np.percentile(
                            [r.coalesce_wait_ms for _, r, _ in runs], 50)),
                        "groups_formed": snap["groupsFormed"],
                        "solo_fallbacks": snap["soloFallbacks"],
                        "group_plane_bytes": rep["bytes"] - rep0["bytes"],
                        "group_plane_host_ms": rep["ms"] - rep0["ms"],
                        # what could stall a query for long: the caching
                        # allocator's cudaMallocs and its retries after
                        # freeing its cache, and full Python collections
                        "device_allocs": mem.get("num_device_alloc", 0)
                        - mem0.get("num_device_alloc", 0),
                        "alloc_retries": mem.get("num_alloc_retries", 0)
                        - mem0.get("num_alloc_retries", 0),
                        "sync_all_streams": mem.get(
                            "num_sync_all_streams", 0)
                        - mem0.get("num_sync_all_streams", 0),
                        "gc_gen2_collections": gc2["collections"]
                        - gc0["collections"]}
    finally:
        gc.unfreeze()
        qe.coalescer = coalescer
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    # the device time of one group's plane repeat (Q = 16) against the
    # family's own stack: what a group pays that a family does not
    stack = max(qe.executor.cache.stacked_view(
        qe._table("ssb").segments)._planes.values(),
        key=lambda t: t.numel() * t.element_size())
    repeat_ms = cuda_ms(torch, lambda: stack.repeat(
        (16,) + (1,) * (stack.dim() - 1)), 5)
    emit({"phase": "coalesce", "card": card, "query": "q2_family",
          "window_ms": float(COALESCE_WINDOW_MS), "iters": COALESCE_ITERS,
          "structure": structure, "timed": timed,
          "largest_stack_bytes": stack.numel() * stack.element_size(),
          "largest_stack_repeat16_ms": repeat_ms,
          "full_collect_ms_before_freeze": full_collect_ms,
          "frozen_objects": frozen, "oracle": "equal",
          "seconds": time.perf_counter() - t_phase})
    return group_inputs


def _explain_sql(sql: str, prefix: str) -> str:
    """`sql` with an EXPLAIN prefix after its SET options."""
    sets = ""
    while sql.startswith("SET "):
        cut = sql.index("; ") + 2
        sets, sql = sets + sql[:cut], sql[cut:]
    return sets + prefix + sql


def phase_explain(torch, qe, expected, card) -> None:
    """EXPLAIN, tracing and EXPLAIN ANALYZE on the card: the EXPLAIN PLAN
    FOR and EXPLAIN IMPLEMENTATION FOR rows of EXPLAIN_QUERIES equal a CPU
    executor's over the same segments (planning is host-only); EXPLAIN
    ANALYZE of q2_family, q2 and q8 renders one family_dispatch span per
    dispatch its untraced run made, each on cuda with deviceExecMs > 0,
    and a traced run's rows equal the oracle's; an untraced warm q2_family
    makes no synchronize, no span, no device timing and its one host
    fetch, as before tracing existed (a traced one synchronizes once per
    dispatch)."""
    import warnings

    import pinot_tpu_torch.engine.executor as ex_mod
    from pinot_tpu_torch.engine.query_executor import QueryExecutor
    from pinot_tpu_torch.ops import kernels as interp
    from pinot_tpu_torch.spi.trace import span_allocations

    t_phase = time.perf_counter()
    cpu = QueryExecutor(device="cpu")
    for name, t in qe.tables.items():
        cpu.add_table(t.schema, t.segments, name)
    rows = {}
    for qname in EXPLAIN_QUERIES:
        for prefix in ("EXPLAIN PLAN FOR ", "EXPLAIN IMPLEMENTATION FOR "):
            sql = _explain_sql(QUERIES[qname], prefix)
            got, want = qe.execute_sql(sql), cpu.execute_sql(sql)
            if got.result_table.rows != want.result_table.rows:
                raise AssertionError(f"explain {qname}: the card's rows "
                                     f"{got.result_table.rows} vs the CPU's "
                                     f"{want.result_table.rows}")
            if got.num_device_dispatches:
                raise AssertionError(f"explain {qname} dispatched")
            rows[f"{prefix.split()[1].lower()}/{qname}"] = len(
                got.result_table.rows)
    del cpu

    analyze = {}
    statements = {"q2_family": QUERIES["q2_family"], "q2": QUERIES["q2"],
                  "q8": MSE_QUERIES["q8"]}
    for qname, sql in statements.items():
        with recording(ex_mod, "_count_dispatch") as counted:
            plain = qe.execute_sql(sql)
        traced = qe.execute_sql("SET trace = true; " + sql)
        _rows_equal(qname, traced, expected[qname], qname == "q8")
        _rows_equal(qname, plain, expected[qname], qname == "q8")
        resp = qe.execute_sql(_explain_sql(sql, "EXPLAIN ANALYZE "))
        if resp.exceptions:
            raise AssertionError(f"analyze {qname}: {resp.exceptions}")
        spans = [sp for sp in resp.trace_info
                 if sp["operator"] == "family_dispatch"]
        exec_ms = [sp["attributes"]["deviceExecMs"] for sp in spans]
        devices = {sp["attributes"]["device"] for sp in spans}
        root = resp.result_table.rows[0][0]
        if (len(spans) != len(counted) or devices != {DEVICE}
                or min(exec_ms) <= 0
                or f"rows:{len(expected[qname])}," not in root):
            raise AssertionError(
                f"analyze {qname}: {len(spans)} family_dispatch spans on "
                f"{devices} ({exec_ms} ms) for {len(counted)} dispatches; "
                f"root {root}")
        analyze[qname] = {"family_dispatch_spans": len(spans),
                          "untraced_dispatches": len(counted),
                          "device_exec_ms": exec_ms,
                          "tree_rows": len(resp.result_table.rows),
                          "root": root}

    # the tracing-off guard on the card
    def counted_run(sql):
        timers = []
        real_timer = ex_mod._DeviceTimer

        class Counting(real_timer):
            def __init__(self, device):
                timers.append(device)
                super().__init__(device)

        ex_mod._DeviceTimer = Counting
        spans0, fetch0 = span_allocations(), interp.host_fetches()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught, \
                    recording(torch.cuda, "synchronize") as syncs, \
                    recording(torch.cuda.Event, "synchronize") as ev_syncs:
                warnings.simplefilter("always")
                qe.execute_sql(sql)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            ex_mod._DeviceTimer = real_timer
        return {"synchronize": len(syncs), "event_synchronize": len(ev_syncs),
                "sync_debug_warnings": sum("synchroniz" in str(w.message)
                                           for w in caught),
                "device_timers": len(timers),
                "spans": span_allocations() - spans0,
                "host_fetches": interp.host_fetches() - fetch0}

    qe.execute_sql(QUERIES["q2_family"])
    untraced = counted_run(QUERIES["q2_family"])
    traced = counted_run("SET trace = true; " + QUERIES["q2_family"])
    if (untraced["synchronize"], untraced["event_synchronize"],
            untraced["device_timers"], untraced["spans"],
            untraced["host_fetches"]) != (0, 0, 0, 0, 1):
        raise AssertionError(f"explain: tracing off added work {untraced}")
    if traced["event_synchronize"] != 1 or traced["spans"] == 0:
        raise AssertionError(f"explain: the traced run {traced}")
    emit({"phase": "explain", "card": card, "explain_rows": rows,
          "explain": "equal to the CPU executor's", "analyze": analyze,
          "untraced_q2_family": untraced, "traced_q2_family": traced,
          "seconds": time.perf_counter() - t_phase})


# the cluster serving path: these queries through the broker, 2 servers
CLUSTER_QUERIES = ("q1", "q2", "q2_family", "q3", "sel_limit")
CLUSTER_SERVERS = 2


def _cluster_start(torch, tmp, schema, segments: int, rows: int,
                   replication: int, store=None, tags=None):
    """A PropertyStore (or `store`), a controller, CLUSTER_SERVERS servers
    on the card (server i tagged `tags[i]` where given) and a broker over
    loopback, with table `ssb` registered from the segment directories
    phase `data` built (no new build)."""
    from pinot_tpu_torch.cluster import (Broker, ClusterController,
                                         PropertyStore, ServerInstance)

    store = store if store is not None else PropertyStore()
    ctl = ClusterController(store)
    servers = [ServerInstance(store, f"Server_{i}", device=DEVICE,
                              tags=tags[i] if tags else None)
               for i in range(CLUSTER_SERVERS)]
    for srv in servers:
        srv.start()
    ctl.add_schema(schema.to_json())
    table = ctl.create_table({"tableName": "ssb", "replication": replication})
    for i in range(segments):
        ctl.add_segment(table, f"ssb_{i}", {"location": f"{tmp}/ssb_{i}",
                                            "numDocs": rows})
    return store, ctl, servers, Broker(store)


def _cluster_stop(cluster) -> None:
    _, _, servers, broker = cluster
    for srv in servers:
        if srv._started:
            srv.stop()
    broker.close()


def _wire(resp) -> dict:
    """One response's wire, summed over its shards (ms on the host clock;
    the servers share this process, so `rpc` includes the other shard's
    work on the same GIL)."""
    w = resp.wire_stats or []
    return {"servers": len(w),
            "datatable_bytes": sum(x["datatableBytes"] for x in w),
            "server_execute_ms": max((x["executeMs"] for x in w), default=0),
            "encode_ms": sum(x["encodeMs"] for x in w),
            "rpc_ms": max((x["rpcMs"] for x in w), default=0),
            "decode_ms": sum(x["decodeMs"] for x in w),
            "route_ms": w[0]["routeMs"] if w else 0.0,
            "merge_reduce_ms": w[0]["mergeReduceMs"] if w else 0.0}


def phase_cluster(args, torch, qe, tmp, schema, expected, _cuda, interp,
                  mxu, fg, card) -> dict:
    """The cluster serving path on the card: 2 ServerInstance(device=
    "cuda") and a Broker over loopback, table `ssb` from phase `data`'s
    directories at replication 1 (2 segments a server). Each query of
    CLUSTER_QUERIES once with every count set to 0 just before it (rows
    against the oracle, 2 servers responding, dispatches equal to the
    families each server's segments form, kernels A and B launched through
    the servers), then --iters warm runs for the broker p50, the same
    query's in-process p50 and the wire; then replication 2: a dropped
    connection and a corrupt DataTable retried on the replica, a server's
    error failing the query (partial with allowPartialResults) as the JAX
    broker does, and the server that answered q2_family stopped with the
    other replica alone answering it. Returns kernel A's recorded q2_family inputs through the
    servers and their launches for the kernel table."""
    from pinot_tpu_torch.spi import faults

    t_phase = time.perf_counter()
    rows = args.rows_per_segment
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    # as in phase `coalesce`: the script's heap is frozen out of the
    # collector, as a server freezes its own after loading, so no full
    # collection of it lands in the timed runs (counted, to be sure)
    gc.collect()
    gc.freeze()
    gen2 = gc.get_stats()[2]["collections"]
    cluster = _cluster_start(torch, tmp, schema, args.segments, rows, 1)
    _, _, servers, broker = cluster
    out = {"queries": {}, "card": card}
    recorded = {}
    try:
        hosted = {srv.instance_id: sorted(srv.segments.get("ssb_OFFLINE", {}))
                  for srv in servers}
        if sorted(n for v in hosted.values() for n in v) != [
                f"ssb_{i}" for i in range(args.segments)]:
            raise AssertionError(f"cluster: segments hosted {hosted}")
        launches = {k: 0 for k in _cuda.LAUNCHES}
        for qname in CLUSTER_QUERIES:
            sql = QUERIES[qname]
            want_disp = sum(family_count(srv.executor, sql, "ssb_OFFLINE")[0]
                            for srv in servers)
            _cuda.reset_launches()
            with recording(mxu, "limb_sums") as a_calls, \
                    recording(fg, "fused_limb_sums") as b_calls:
                t0 = time.perf_counter()
                resp = broker.execute_sql(sql)
                torch.cuda.synchronize()
                cold_ms = (time.perf_counter() - t0) * 1e3
            made = dict(_cuda.LAUNCHES)
            if resp.exceptions:
                raise AssertionError(f"cluster {qname}: {resp.exceptions}")
            _rows_equal(f"cluster {qname}", resp, expected[qname],
                        qname in ORDERED)
            if resp.num_servers_queried != CLUSTER_SERVERS or \
                    resp.num_servers_responded != CLUSTER_SERVERS:
                raise AssertionError(
                    f"cluster {qname}: {resp.num_servers_responded} of "
                    f"{resp.num_servers_queried} servers responded")
            if resp.num_device_dispatches != want_disp:
                raise AssertionError(
                    f"cluster {qname}: {resp.num_device_dispatches} "
                    f"dispatches, the servers' families {want_disp}")
            kernel = EXPECTED_KERNEL.get(qname)
            if kernel is not None and made[kernel] == 0:
                raise AssertionError(f"cluster {qname} did not launch {kernel}")
            if made["limb_sums"] != len(a_calls) or \
                    made["fused_limb_sums"] != len(b_calls):
                raise AssertionError(f"cluster {qname}: {made} launches, "
                                     f"{len(a_calls)} + {len(b_calls)} calls")
            for k in launches:
                launches[k] += made[k]
            recorded[qname] = (a_calls, b_calls)
            ts, local, wires = [], [], []
            for _ in range(args.iters):
                t0 = time.perf_counter()
                r = broker.execute_sql(sql)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
                wires.append(_wire(r))
                t0 = time.perf_counter()
                qe.execute_sql(sql)
                torch.cuda.synchronize()
                local.append((time.perf_counter() - t0) * 1e3)
            out["queries"][qname] = {
                "rows": len(resp.result_table.rows), "cold_ms": cold_ms,
                "broker_p50_ms": float(np.median(ts)),
                "broker_p25_p75_ms": [float(q) for q in
                                      np.percentile(ts, [25, 75])],
                "in_process_p50_ms": float(np.median(local)),
                "device_dispatches": resp.num_device_dispatches,
                "in_process_dispatches": qe.execute_sql(
                    sql).num_device_dispatches,
                "launches": made,
                "wire_p50": {k: float(np.median([w[k] for w in wires]))
                             for k in wires[0]}}
        for k, v in launches.items():
            if v == 0:
                raise AssertionError(f"the cluster path never launched {k}")
        out["launches"] = launches
        out["server_cache_bytes"] = {
            srv.instance_id: srv.executor.executor.cache.bytes_used()
            for srv in servers}
        torch.cuda.synchronize()
        out["allocated_bytes_over_phase_start"] = \
            torch.cuda.memory_allocated() - mem0
        out["health"] = servers[0]._handle({"type": "status"})["device"]
        # the flight recorder and the sentinel on these servers
        fr = phase_flight_recorder(args, torch, cluster, tmp, schema,
                                   expected, _cuda, mxu, fg, card)
    finally:
        _cluster_stop(cluster)
    parity = {}
    for k, rec in enumerate(recorded["q2_family"][0]):
        parity[f"limb_sums/cluster_q2_family/server{k}"] = check_equal(
            torch, f"limb_sums cluster q2_family, server {k}",
            mxu.limb_sums(*rec), mxu.limb_sums_plain(*rec))
    for k, rec in enumerate(recorded["q2"][1]):
        parity[f"fused_limb_sums/cluster_q2/launch{k}"] = check_equal(
            torch, f"fused_limb_sums cluster q2, launch {k}",
            fg.fused_limb_sums(*rec), fg.fused_limb_sums_plain(*rec))
    out["parity"] = parity
    del cluster, servers, broker
    gc.collect()
    torch.cuda.empty_cache()

    # replication 2: every segment on both servers
    cluster = _cluster_start(torch, tmp, schema, args.segments, rows, 2)
    _, _, servers, broker = cluster
    sql, want = QUERIES["q2_family"], expected["q2_family"]
    failures = {}
    try:
        resp = broker.execute_sql(sql)
        _rows_equal("cluster rep2", resp, want, False)
        # the query's first RPC drops (the connection-failure shape): its
        # shard fails over to the other replica
        faults.FAULTS.arm("transport.call", kind="drop", times=1)
        resp = broker.execute_sql(sql)
        fired = faults.FAULTS.fired("transport.call")
        faults.FAULTS.reset()
        _rows_equal("cluster drop", resp, want, False)
        if fired != 1 or resp.num_scatter_retries < 1:
            raise AssertionError(f"cluster drop: {fired} drops, "
                                 f"{resp.num_scatter_retries} retries")
        failures["transport.call drop"] = {
            "retries": resp.num_scatter_retries,
            "servers_responded": resp.num_servers_responded}
        faults.FAULTS.arm("datatable.encode", kind="corrupt", times=1)
        resp = broker.execute_sql(sql)
        faults.FAULTS.reset()
        _rows_equal("cluster corrupt", resp, want, False)
        if resp.num_corrupt_shards_retried != 1 or \
                resp.num_scatter_retries < 1:
            raise AssertionError(
                f"cluster corrupt: {resp.num_corrupt_shards_retried} "
                f"corrupt shards, {resp.num_scatter_retries} retries")
        failures["datatable.encode corrupt"] = {
            "retries": resp.num_scatter_retries,
            "corrupt_shards": resp.num_corrupt_shards_retried}
        # a handler's error: terminal (RemoteError), as in the JAX broker
        faults.FAULTS.arm("server.query", kind="error", times=1)
        resp = broker.execute_sql(sql)
        faults.FAULTS.arm("server.query", kind="error", times=1)
        part = broker.execute_sql("SET allowPartialResults = true; " + sql)
        faults.FAULTS.reset()
        if resp.result_table is not None or not resp.exceptions[0] \
                .startswith("RemoteError") or not part.partial_result:
            raise AssertionError(f"cluster server.query error: "
                                 f"{resp.exceptions} / {part.exceptions}")
        failures["server.query error"] = {
            "exception": resp.exceptions[0][:80],
            "partial_servers_responded": part.num_servers_responded}
        # failover: stop a server that answered the last query (adaptive
        # selection may route every segment to one replica), and the
        # query is answered by the other replica alone
        resp = broker.execute_sql(sql)
        answered = sorted({w["server"] for w in resp.wire_stats or []})
        if not answered:
            raise AssertionError("cluster failover: no server answered")
        victim = answered[0]
        next(s for s in servers if s.instance_id == victim).stop()
        resp = broker.execute_sql(sql)
        _rows_equal("cluster failover", resp, want, False)
        after = sorted({w["server"] for w in resp.wire_stats or []})
        if resp.num_servers_responded != 1 or victim in after or not after:
            raise AssertionError(
                f"cluster failover: {victim} stopped, then "
                f"{resp.num_servers_responded} servers ({after}) answered")
        failures["failover"] = {
            "answered_before": answered, "stopped": victim,
            "answered_after": after,
            "servers_responded": resp.num_servers_responded,
            "device_dispatches": resp.num_device_dispatches}
    finally:
        faults.FAULTS.reset()
        _cluster_stop(cluster)
        out["gc_gen2_collections"] = gc.get_stats()[2]["collections"] - gen2
        gc.unfreeze()
    del cluster, servers, broker
    gc.collect()
    torch.cuda.empty_cache()
    out["failures"] = failures
    seconds = time.perf_counter() - t_phase - fr["seconds"]
    emit(dict({"phase": "cluster", "servers": CLUSTER_SERVERS,
               "replication": [1, 2], "seconds": seconds,
               "budget_s": CLUSTER_BUDGET_S,
               "note": "one process: the servers and the broker share its "
                       "GIL, so wire times are a one-process cluster's; "
                       "phase flight_recorder's seconds are not counted"},
              **out))
    emit(fr.pop("line"))
    return {"flight_recorder": fr, "q2_family": recorded["q2_family"][0],
            "launches": out["queries"]["q2_family"]["launches"]["limb_sums"],
            "err": max(v for k, v in parity.items()
                       if k.startswith("limb_sums/cluster_q2_family"))}


# the phase's share of the run's 1200 s limit (reported beside `seconds`)
CLUSTER_BUDGET_S = 60.0
FLIGHT_RECORDER_BUDGET_S = 90.0
# the sentinel loop: at most this many rounds of SENTINEL_BURST queries to
# fire under the dispatch delay, and as many clean ones to clear
SENTINEL_ROUNDS = 12
SENTINEL_BURST = 6
SENTINEL_DELAY_S = 0.05
# a retention reason must not depend on this host's speed
FR_SLOW_THRESHOLD_MS = 60_000.0


def _chrome_checked(trace_events: dict, servers: set) -> dict:
    """A retained trace's Chrome export, checked: matched B/E pairs on
    every lane, every flow an s/f pair, a process per participant, and a
    scatter flow reaching every server. Returns its counts."""
    from collections import defaultdict

    stacks, flows, procs = defaultdict(list), defaultdict(list), {}
    for e in trace_events["traceEvents"]:
        if e["ph"] == "M":
            if e["name"] == "process_name":
                procs[e["pid"]] = e["args"]["name"]
        elif e["ph"] == "B":
            stacks[(e["pid"], e["tid"])].append(e["name"])
        elif e["ph"] == "E":
            lane = stacks[(e["pid"], e["tid"])]
            if not lane or lane.pop() != e["name"]:
                raise AssertionError(f"chrome export: unmatched E {e}")
        else:
            flows[e["id"]].append(e["ph"])
    if any(stacks.values()) or any(sorted(f) != ["f", "s"]
                                   for f in flows.values()):
        raise AssertionError("chrome export: unbalanced B/E or flows")
    if set(procs.values()) != {"broker"} | servers:
        raise AssertionError(f"chrome export: processes {procs}")
    return {"events": len(trace_events["traceEvents"]),
            "flows": len(flows), "processes": sorted(procs.values())}


AOT_CHILD = r"""
import json, sys, time
import torch
from pinot_tpu_torch.engine import aot_cache
from pinot_tpu_torch.engine.compile_registry import COMPILE_REGISTRY
from pinot_tpu_torch.engine.query_executor import QueryExecutor
from pinot_tpu_torch.engine.reduce import BrokerReducer
from pinot_tpu_torch.query.parser.sql import parse_sql
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.spi.data_types import Schema
from pinot_tpu_torch.spi.metrics import SERVER_METRICS

device, schema = sys.argv[1], Schema.from_json(json.loads(sys.argv[2]))
sql = sys.argv[3]
segments = [load_segment(p) for p in sys.argv[4:]]
sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
torch.zeros(1, device=device)
sync()
qe = QueryExecutor(device=device)
t0 = time.perf_counter()
qe.add_table(schema, segments)
sync()
add_ms = (time.perf_counter() - t0) * 1e3
before = COMPILE_REGISTRY.snapshot()
# each run split as phase `layers` splits a warm query, so the cold run
# shows where a first query's time goes
times, layers = [], []
for _ in range(2):
    t0 = time.perf_counter()
    query = parse_sql(sql)
    table = qe._table(query.table_name)
    routes = qe.route_segments(query, qe.prune_segments(
        query, qe.pinned_segments(table.segments))[0])
    plans = qe.plan_segments(routes)
    t1 = time.perf_counter()
    pending = qe.dispatch_segments(query, routes, plans)
    sync()
    t2 = time.perf_counter()
    inter = qe.collect_segments(routes, plans, pending)
    t3 = time.perf_counter()
    rows = BrokerReducer(table.schema).reduce(
        query, qe._combine(query, inter)).rows
    t4 = time.perf_counter()
    times.append((t4 - t0) * 1e3)
    layers.append(dict(zip(("parse_plan_ms", "dispatch_ms", "collect_ms",
                            "combine_reduce_ms"),
                           ((b - a) * 1e3 for a, b in zip(
                               (t0, t1, t2, t3), (t1, t2, t3, t4))))))
snap = SERVER_METRICS.snapshot()
prewarm = snap["timers"].get("aotPrewarmMs", {})
print(json.dumps({
    "aot": aot_cache.enabled(), "add_table_ms": add_ms,
    "prewarm_ms": prewarm.get("totalMs", 0.0),
    "families_loaded": len(aot_cache.AOT_READY),
    "families_before_first_query": before["families"],
    "first_ms": times[0], "second_ms": times[1], "rows": len(rows),
    "first_layers": layers[0], "second_layers": layers[1],
    "aot_hits": snap["meters"].get("aotCacheHits", 0),
    "aot_misses": snap["meters"].get("aotCacheMisses", 0),
    "cold_ms": {e["fingerprint"][:12]: e["compileMsLast"]
                for e in COMPILE_REGISTRY.snapshot()["compiles"]}}))
"""


def _aot_child(schema, sql, paths, aot_dir):
    """Start one AOT child process on the card: a QueryExecutor over
    `paths` (prewarmed from `aot_dir` where given), then `sql` twice.
    Returns (the process, its start time) for _aot_result."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PINOT_TPU_AOT_CACHE_DIR", "PINOT_TPU_TRACE_SAMPLE")}
    if aot_dir:
        env["PINOT_TPU_AOT_CACHE_DIR"] = aot_dir
    return subprocess.Popen(
        [sys.executable, "-c", AOT_CHILD, DEVICE,
         json.dumps(schema.to_json()), sql, *paths],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__))), time.perf_counter()


def _aot_result(proc, t0) -> dict:
    """An AOT child's result line, once it exits (killed past 300 s)."""
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"aot child failed:\n{stderr[-3000:]}")
    res = json.loads(stdout.strip().splitlines()[-1])
    res["process_s"] = time.perf_counter() - t0
    return res


def phase_flight_recorder(args, torch, cluster, tmp, schema, expected,
                          _cuda, mxu, fg, card) -> dict:
    """The flight recorder and the regression sentinel on phase `cluster`'s
    2 card servers and broker (replication 1). The registry, family guard
    and AOT state start empty, as in a fresh process, and the AOT cache
    persists into this run's directory. 1: with PINOT_TPU_TRACE_SAMPLE =
    1.0, q2_family (kernel A on each server's family) and q2 (kernel B a
    segment), counts set to 0 just before each: rows against the oracle,
    the trace retained as `sampled` with the broker's and both servers'
    spans, its Chrome export checked, each kernel call against its plain
    version. 2: q2_family's broker p50 over --iters, sampling at 0 and 1.0
    in turns. 3: the sentinel on the card: a baseline, a `device.dispatch`
    delay until `latency-drift` fires, its exemplar traces, the clean
    rounds that clear it, the ledger persisted and restored. 4: the
    registry's families and dispatches against the responses'. 5: q2_family
    in two child processes on the card, run side by side, one prewarmed
    from this run's records and one not."""
    from pinot_tpu_torch.cluster.sentinel import (SENTINEL_REPORT_PATH,
                                                  PerfRegressionSentinel)
    from pinot_tpu_torch.engine import aot_cache
    from pinot_tpu_torch.engine import executor as executor_mod
    from pinot_tpu_torch.engine.compile_registry import COMPILE_REGISTRY
    from pinot_tpu_torch.engine.perf_ledger import (ALERTS, LEDGER_PATH,
                                                    PERF_LEDGER, PerfLedger)
    from pinot_tpu_torch.spi import faults
    from pinot_tpu_torch.spi.trace import TRACE_SAMPLE_ENV
    from pinot_tpu_torch.spi.traceexport import to_chrome_trace

    t_phase = time.perf_counter()
    store, ctl, servers, broker = cluster
    names = {s.instance_id for s in servers}
    aot_dir = os.path.join(tmp, "aot")
    _set_env("PINOT_TPU_AOT_CACHE_DIR", aot_dir)
    aot_cache.reset()
    executor_mod._FAMILIES.clear()
    COMPILE_REGISTRY.reset()
    PERF_LEDGER.clear()
    ALERTS.clear()
    broker.query_logger.slow_threshold_ms = FR_SLOW_THRESHOLD_MS
    out = {"card": card}
    dispatched = [0]

    def run(sql):
        resp = broker.execute_sql(sql)
        if resp.exceptions:
            raise AssertionError(f"flight_recorder: {resp.exceptions}")
        dispatched[0] += resp.num_device_dispatches
        return resp

    recs = {}
    try:
        # -- 1: sampled retention through both kernels ------------------
        _set_env(TRACE_SAMPLE_ENV, "1.0")
        retained = {}
        for qname, kernel, want in (("q2_family", "limb_sums",
                                     CLUSTER_SERVERS),
                                    ("q2", "fused_limb_sums",
                                     args.segments)):
            _cuda.reset_launches()
            with recording(mxu, "limb_sums") as a_calls, \
                    recording(fg, "fused_limb_sums") as b_calls:
                resp = run(QUERIES[qname])
                torch.cuda.synchronize()
            made = dict(_cuda.LAUNCHES)
            _rows_equal(f"flight_recorder {qname}", resp, expected[qname],
                        qname in ORDERED)
            if made[kernel] != want or resp.trace_info is not None:
                raise AssertionError(f"flight_recorder {qname}: {made}, "
                                     f"trace shipped {bool(resp.trace_info)}")
            ent = broker.trace_store.get(resp.query_id)
            if ent is None or ent["reason"] != "sampled":
                raise AssertionError(f"flight_recorder {qname}: retained "
                                     f"{ent and ent['reason']}")
            spans = ent["spans"]
            if {s.get("server") for s in spans} - {None} != names or \
                    not {"BROKER_SCATTER", "BROKER_REDUCE"} <= {
                        s["operator"] for s in spans}:
                raise AssertionError(f"flight_recorder {qname}: spans of "
                                     f"{[s['operator'] for s in spans]}")
            retained[qname] = dict(
                _chrome_checked(to_chrome_trace(spans, resp.query_id),
                                names),
                spans=len(spans), launches=made,
                dispatches=resp.num_device_dispatches,
                bytes=ent["bytes"])
            recs[qname] = a_calls if kernel == "limb_sums" else b_calls
        out["retained"] = retained
        parity = {}
        for k, rec in enumerate(recs["q2_family"]):
            parity[f"limb_sums/fr_q2_family/server{k}"] = check_equal(
                torch, f"limb_sums flight_recorder q2_family, server {k}",
                mxu.limb_sums(*rec), mxu.limb_sums_plain(*rec))
        for k, rec in enumerate(recs["q2"]):
            parity[f"fused_limb_sums/fr_q2/launch{k}"] = check_equal(
                torch, f"fused_limb_sums flight_recorder q2, launch {k}",
                fg.fused_limb_sums(*rec), fg.fused_limb_sums_plain(*rec))
        out["parity"] = parity

        # -- 2: what sampling costs a query -----------------------------
        sql = QUERIES["q2_family"]
        ts = {"0": [], "1.0": []}
        for _ in range(args.iters):
            for rate in ("0", "1.0"):
                _set_env(TRACE_SAMPLE_ENV, rate)
                t0 = time.perf_counter()
                run(sql)
                torch.cuda.synchronize()
                ts[rate].append((time.perf_counter() - t0) * 1e3)
        out["sampling"] = {
            f"broker_p50_ms_at_{r}": float(np.median(v))
            for r, v in ts.items()}
        out["sampling"]["cost_ms"] = float(np.median(ts["1.0"])
                                           - np.median(ts["0"]))
        out["sampling"]["trace_store"] = broker.trace_store.stats()

        # -- 3: the sentinel on the card --------------------------------
        _set_env(TRACE_SAMPLE_ENV, "0")
        PERF_LEDGER.clear()
        ALERTS.clear()
        for _ in range(8):
            run(sql)
        PERF_LEDGER.rotate_now()
        # the reference persisted before the fault, the ledger restarted
        # from it after (as a controller taking over restores
        # /PERF/LEDGER), so the recovery is judged on recovery queries
        # alone: with the fault's queries left in the short window its p50
        # stayed past the drift rule once though the latency was back
        # (26.9 ms against 38.1, 88 queries in the window)
        PERF_LEDGER.persist(store)
        sentinel = PerfRegressionSentinel(store, ctl, min_queries=3,
                                          breaches=2, clears=2)
        report = sentinel.evaluate()
        if report["anomalies"]:
            raise AssertionError(f"sentinel baseline: {report['anomalies']}")
        alert, fire_rounds = None, 0
        with faults.injected("device.dispatch", kind="delay",
                             delay_s=SENTINEL_DELAY_S, times=None):
            for fire_rounds in range(1, SENTINEL_ROUNDS + 1):
                for _ in range(SENTINEL_BURST):
                    run(sql)
                report = sentinel.evaluate()
                if ALERTS.active_count:
                    alert = ALERTS.active()[0]
                    break
            if alert is None or alert["type"] != "latency-drift":
                raise AssertionError(f"sentinel: no latency-drift alert "
                                     f"after {fire_rounds} rounds ({alert})")
            for _ in range(4):  # the exemplar claims
                run(sql)
        exemplars = ALERTS.get(alert["id"])["exemplarTraceIds"]
        ent = broker.trace_store.get(exemplars[0]) if exemplars else None
        if ent is None or alert["id"] not in ent.get("alertIds", []):
            raise AssertionError(f"sentinel: exemplars {exemplars}")
        # an exemplar claim forces the broker's sampling only: the
        # servers decide by the rate (0 here), as in the JAX package
        exemplar_chrome = _chrome_checked(
            to_chrome_trace(ent["spans"], exemplars[0]), set())
        PERF_LEDGER.clear()
        if PERF_LEDGER.restore(store) < 1:
            raise AssertionError("sentinel: the reference was not restored")
        clear_rounds = 0
        for clear_rounds in range(1, SENTINEL_ROUNDS + 1):
            for _ in range(SENTINEL_BURST):
                run(sql)
            sentinel.evaluate()
            if not ALERTS.active_count:
                break
        rec = ALERTS.get(alert["id"])
        if ALERTS.active_count or rec["clearReason"] != "recovered":
            raise AssertionError(f"sentinel: never cleared ({rec})")
        scrape = sentinel()
        restored = PerfLedger().restore(store)
        if store.get(LEDGER_PATH) is None or restored < 1 or \
                store.get(SENTINEL_REPORT_PATH) is None:
            raise AssertionError("sentinel: ledger or report not persisted")
        out["sentinel"] = {
            "rounds_to_fire": fire_rounds, "rounds_to_clear": clear_rounds,
            "round_queries": SENTINEL_BURST,
            "delay_ms": SENTINEL_DELAY_S * 1e3,
            "alert": {k: alert[k] for k in ("id", "type", "summary")},
            "details": alert["details"], "exemplars": len(exemplars),
            "exemplar_chrome": exemplar_chrome,
            "plans_restored": restored,
            "bench_baseline": scrape["benchBaseline"]}

        # -- 4: the registry against the responses ----------------------
        snap = COMPILE_REGISTRY.snapshot()
        if snap["totalDispatches"] != dispatched[0] or \
                snap["totalCompiles"] != 0:
            raise AssertionError(
                f"registry: {snap['totalDispatches']} dispatches, the "
                f"responses {dispatched[0]}; {snap['totalCompiles']} compiles")
        out["registry"] = {
            "families": snap["families"],
            "dispatches": snap["totalDispatches"],
            "responses_dispatches": dispatched[0],
            "cold_ms": {f"{e['family']['mode']}/S{e['family']['batchSize']}"
                        f"/{e['family']['fused'] or 'two-step'}":
                        e["compileMsLast"] for e in snap["compiles"]},
            "aot_records": aot_cache.stats()}
    finally:
        faults.FAULTS.reset()
        _set_env(TRACE_SAMPLE_ENV, None)
        _set_env("PINOT_TPU_AOT_CACHE_DIR", None)
        PERF_LEDGER.clear()
        ALERTS.clear()

    # -- 5: AOT in two child processes on the card, side by side (one after
    # the other, 26.7 s, before phase soak joined the run) --------------
    hosted = sorted(servers[0].segments.get("ssb_OFFLINE", {}))
    paths = [f"{tmp}/{name}" for name in hosted]
    started = {"without_aot": _aot_child(schema, sql, paths, None),
               "with_aot": _aot_child(schema, sql, paths, aot_dir)}
    try:
        children = {k: _aot_result(*v) for k, v in started.items()}
    finally:
        for proc, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if children["with_aot"]["aot_hits"] < 1 or \
            children["with_aot"]["families_loaded"] < 1 or \
            children["without_aot"]["aot_hits"] != 0:
        raise AssertionError(f"aot children: {children}")
    if children["with_aot"]["rows"] != children["without_aot"]["rows"]:
        raise AssertionError(f"aot children rows: {children}")
    out["aot_children"] = children
    out["aot_children"]["segments"] = hosted
    seconds = time.perf_counter() - t_phase
    line = dict({"phase": "flight_recorder", "servers": len(servers),
                 "seconds": seconds, "budget_s": FLIGHT_RECORDER_BUDGET_S,
                 "note": "one process: the servers and the broker share its "
                         "GIL; cold_ms is each family's first dispatch "
                         "after a registry reset in this warm process, the "
                         "AOT children's first_ms a cold process's (the two "
                         "children run side by side, on one card)"}, **out)
    return {"seconds": seconds, "line": line,
            "a_recs": recs["q2_family"], "b_recs": recs["q2"],
            "a_launches": retained["q2_family"]["launches"]["limb_sums"],
            "b_launches": retained["q2"]["launches"]["fused_limb_sums"],
            "a_err": max(v for k, v in parity.items()
                         if k.startswith("limb_sums/")),
            "b_err": max(v for k, v in parity.items()
                         if k.startswith("fused_limb_sums/"))}


# the phase's share of the run's 1200 s limit (reported beside `seconds`)
MSE_CLUSTER_BUDGET_S = 120.0
# the child server process's start (spawn, torch, the card, its segments)
CHILD_START_S = 180.0


def _await(predicate, timeout_s: float, what: str) -> None:
    deadline = time.monotonic() + timeout_s
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"mse_cluster: timed out waiting for {what}")
        time.sleep(0.05)


def _stage_summary(resps: list) -> dict:
    """Per stage over warm runs: workers, median wall ms (the slowest
    worker's), rows and bytes shuffled and PTDP bytes (the last run's)."""
    out = {}
    for sid, st in resps[-1].mse_stage_stats.items():
        out[str(sid)] = {
            "workers": st["workers"], "leaf_pushdown": st["leaf_pushdown"],
            "wall_ms": float(np.median([r.mse_stage_stats[sid]["wall_ms"]
                                        for r in resps])),
            "rows_in": st["rows_in"], "rows_out": st["rows_out"],
            "shuffled_rows": st["shuffled_rows"],
            "shuffled_bytes": st["shuffled_bytes"],
            "packed_bytes": st["packed_bytes"]}
    return out


def _exchange_view(resp) -> dict:
    ex = resp.mse_exchange
    return {k: ex[k] for k in ("packed_bytes", "packed_blocks",
                               "packed_bytes_by", "mailbox_bytes_total",
                               "mailbox_bytes_peak",
                               "mailbox_duplicates_dropped", "workers")}


def _set_env(name: str, value: str | None) -> None:
    """Set ``name`` to ``value``, or unset it for None."""
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


def _warm(torch, broker, sql, iters) -> tuple:
    """--iters warm runs (1 for a statement whose first warm run took over
    1 s, as in `times`): (times, responses)."""
    ts, resps = [], []
    while len(ts) < (1 if ts and ts[0] > SLOW_QUERY_MS else iters):
        t0 = time.perf_counter()
        r = broker.execute_sql(sql)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
        if r.exceptions:
            raise AssertionError(f"mse_cluster warm: {r.exceptions}")
        resps.append(r)
    return ts, resps


def phase_mse_cluster(args, torch, tmp, schema, expected, _cuda, mxu, fg,
                      in_process_p50, card) -> dict:
    """The cluster multi-stage engine (mse/distributed.py) on the card: the
    phase `cluster` layout (2 ServerInstance(device="cuda"), a Broker,
    `ssb` from phase `data`'s directories at replication 1, 2 segments a
    server), its PropertyStore served by a PropertyStoreServer. Each of
    q8, q10, mse_agg and mse_agg_solo (MSE_CLUSTER_QUERIES) once with every
    count set to 0 just before it: rows against the oracle, stage workers
    on both servers, the fused stage never taken (in-process only), kernel
    A once a server on mse_agg and kernel B once a segment on
    mse_agg_solo (their recorded inputs held against the plain versions
    after the phase), and on q8 and q10 the join workers' pair join
    (device_join_indices, gather_payload) on cuda, PTDP bytes > 0 (the
    DEVICE_PACKED_EXCHANGE_BYTES meter) and pack_u8_wire given cuda
    tensors. The pair join is forced with the deployment knob
    PINOT_TPU_DEVICE_JOIN=1 for the phase: each of the 2 join workers sees
    about 2.2M key rows of q8, under the 4M auto gate. Then --iters warm
    runs a statement: broker p50 beside phase `mse`'s in-process p50, per
    stage workers, wall ms, shuffled rows and bytes, PTDP bytes and the
    mailbox peak; and --iters warm runs of q8 without the knob, the host
    pair join a user's cluster takes. Then a `mailbox.deliver` failure
    (its re-sent chunk dropped as a duplicate, rows equal); a server in a second OS process
    (spawn) on the same card joining through RemoteStore, `ssb_l` on
    Server_0 and `ssb_r` on the child, and q8 across them (rows, workers
    in both processes, PTDP bytes from the child, broker p50); last,
    Server_1's endpoint closed (a crash): q8 answers with an exception
    within its timeoutMs and every in-process mailbox store is empty."""
    from pinot_tpu_torch.cluster.remote_store import (PropertyStoreServer,
                                                      serve_server_process)
    from pinot_tpu_torch.mse import device_join
    from pinot_tpu_torch.ops import kernels
    from pinot_tpu_torch.spi import faults
    from pinot_tpu_torch.spi.metrics import SERVER_METRICS, ServerMeter

    t_phase = time.perf_counter()
    rows = args.rows_per_segment
    meter = ServerMeter.DEVICE_PACKED_EXCHANGE_BYTES
    gc.collect()
    gc.freeze()
    gen2 = gc.get_stats()[2]["collections"]
    prev_join = os.environ.get("PINOT_TPU_DEVICE_JOIN")
    os.environ["PINOT_TPU_DEVICE_JOIN"] = "1"
    store_server = PropertyStoreServer()
    cluster = _cluster_start(torch, tmp, schema, args.segments, rows, 1,
                             store=store_server.store,
                             tags=[["DefaultTenant", "tenantL"],
                                   ["DefaultTenant"]])
    store, ctl, servers, broker = cluster
    names = {s.instance_id for s in servers}
    out = {"queries": {}, "card": card, "servers": CLUSTER_SERVERS,
           "pair_join_forced": "PINOT_TPU_DEVICE_JOIN=1"}
    recorded, launches = {}, {k: 0 for k in _cuda.LAUNCHES}
    child = None
    try:
        for qname in ("q8", "q10", "mse_agg", "mse_agg_solo"):
            sql = MSE_CLUSTER_QUERIES[qname]
            agg = qname.startswith("mse_agg")
            _cuda.reset_launches()
            meter0 = SERVER_METRICS.meter_count(meter)
            with recording(mxu, "limb_sums") as a_calls, \
                    recording(fg, "fused_limb_sums") as b_calls, \
                    recording(device_join, "device_join_indices") as pairs, \
                    recording(device_join, "gather_payload") as gathers, \
                    recording(device_join, "run_fused") as fused, \
                    recording(kernels, "pack_u8_wire") as packs:
                t0 = time.perf_counter()
                resp = broker.execute_sql(sql)
                torch.cuda.synchronize()
                cold_ms = (time.perf_counter() - t0) * 1e3
            made = dict(_cuda.LAUNCHES)
            packed = SERVER_METRICS.meter_count(meter) - meter0
            pack_devices = sorted({t.device.type for call in packs
                                   for t in call[0]})
            del packs
            if resp.exceptions:
                raise AssertionError(f"mse_cluster {qname}: {resp.exceptions}")
            _rows_equal(f"mse_cluster {qname}", resp,
                        expected["mse_agg" if agg else qname], not agg)
            ex = resp.mse_exchange
            if set(ex["workers"]) != names or fused:
                raise AssertionError(
                    f"mse_cluster {qname}: stage workers {ex['workers']}, "
                    f"{len(fused)} fused stages")
            if made["limb_sums"] != len(a_calls) or \
                    made["fused_limb_sums"] != len(b_calls):
                raise AssertionError(f"mse_cluster {qname}: {made} launches, "
                                     f"{len(a_calls)} + {len(b_calls)} calls")
            want = {"mse_agg": ("limb_sums", CLUSTER_SERVERS),
                    "mse_agg_solo": ("fused_limb_sums", args.segments)}
            if qname in want and made[want[qname][0]] != want[qname][1]:
                raise AssertionError(f"mse_cluster {qname}: {made} launches, "
                                     f"{want[qname]} expected")
            pair_devices = sorted({str(torch.device(c[3]).type) for c in pairs}
                                  | {str(torch.device(c[2]).type)
                                     for c in gathers})
            card_type = [torch.device(DEVICE).type]
            if not agg and (not pairs or pair_devices != card_type
                            or packed <= 0 or packed != ex["packed_bytes"]
                            or pack_devices != card_type):
                raise AssertionError(
                    f"mse_cluster {qname}: {len(pairs)} pair joins on "
                    f"{pair_devices}, {packed} PTDP bytes (exchange "
                    f"{ex['packed_bytes']}), packed from {pack_devices}")
            for k in launches:
                launches[k] += made[k]
            recorded[qname] = (list(a_calls), list(b_calls))
            ts, resps = _warm(torch, broker, sql, args.iters)
            out["queries"][qname] = {
                "rows": len(resp.result_table.rows), "cold_ms": cold_ms,
                "broker_p50_ms": float(np.median(ts)),
                "broker_p25_p75_ms": [float(q) for q in
                                      np.percentile(ts, [25, 75])],
                "warm_runs": len(ts),
                "in_process_p50_ms": in_process_p50.get(qname),
                "launches": made, "pair_joins": len(pairs),
                "payload_gathers": len(gathers),
                "pair_join_devices": pair_devices,
                "pack_devices": pack_devices, "ptdp_bytes_meter": packed,
                "exchange": _exchange_view(resps[-1]),
                "stages": _stage_summary(resps)}
        out["launches"] = launches

        # the path a user's cluster takes: the auto gate, under which each
        # join worker's 2.2M key rows of q8 join on the host
        _set_env("PINOT_TPU_DEVICE_JOIN", prev_join)
        with recording(device_join, "device_join_indices") as pairs:
            ts, resps = _warm(torch, broker, MSE_CLUSTER_QUERIES["q8"],
                              args.iters)
        os.environ["PINOT_TPU_DEVICE_JOIN"] = "1"
        _rows_equal("mse_cluster q8 auto", resps[0], expected["q8"], True)
        out["q8_auto_gate"] = {
            "broker_p50_ms": float(np.median(ts)),
            "broker_p25_p75_ms": [float(q) for q in
                                  np.percentile(ts, [25, 75])],
            "warm_runs": len(ts), "pair_joins_on_card": len(pairs),
            "stages": _stage_summary(resps)}
        del pairs

        # a lost acknowledgement: the sender re-sends, the store drops it
        faults.FAULTS.arm("mailbox.deliver", kind="error", times=1,
                          match=lambda c: c.get("chunk"))
        resp = broker.execute_sql(MSE_CLUSTER_QUERIES["q8"])
        fired = faults.FAULTS.fired("mailbox.deliver")
        faults.FAULTS.reset()
        if resp.exceptions:
            raise AssertionError(f"mse_cluster deliver: {resp.exceptions}")
        _rows_equal("mse_cluster deliver", resp, expected["q8"], True)
        dups = resp.mse_exchange["mailbox_duplicates_dropped"]
        if fired != 1 or dups < 1:
            raise AssertionError(f"mse_cluster deliver: {fired} faults, "
                                 f"{dups} duplicates dropped")
        out["deliver_failure"] = {"faults": fired, "duplicates_dropped": dups}

        # a server in a second OS process on the same card
        t0 = time.perf_counter()
        host, port = store_server.address
        child = multiprocessing.get_context("spawn").Process(
            target=serve_server_process,
            args=(host, port, "Remote_0", DEVICE,
                  ["DefaultTenant", "tenantR"]), daemon=True)
        child.start()
        _await(lambda: "Remote_0" in store.children("/LIVEINSTANCES"),
               CHILD_START_S, "the child server's liveness")
        for table, tag in (("ssb_l", "tenantL"), ("ssb_r", "tenantR")):
            ctl.add_schema(dict(schema.to_json(), schemaName=table))
            t = ctl.create_table({"tableName": table, "replication": 1,
                                  "serverTag": tag})
            for i in range(args.segments):
                ctl.add_segment(t, f"ssb_{i}", {
                    "location": f"{tmp}/ssb_{i}", "numDocs": rows})
        _await(lambda: all(
            "Remote_0" in m for m in (store.get(
                "/EXTERNALVIEW/ssb_r_OFFLINE") or {}).values()) and len(
            store.get("/EXTERNALVIEW/ssb_r_OFFLINE") or {}) == args.segments,
            CHILD_START_S, "the child server's segments")
        start_s = time.perf_counter() - t0
        sql = MSE_CLUSTER_QUERIES["q8_two_process"]
        if "ssb_r" not in sql:
            raise AssertionError("q8_two_process does not name ssb_r")
        t0 = time.perf_counter()
        resp = broker.execute_sql(sql)
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        if resp.exceptions:
            raise AssertionError(f"mse_cluster two-process: {resp.exceptions}")
        _rows_equal("mse_cluster two-process", resp, expected["q8"], True)
        ex = resp.mse_exchange
        if "Remote_0" not in ex["workers"] or not names & set(ex["workers"]) \
                or ex["packed_bytes_by"].get("Remote_0", 0) <= 0:
            raise AssertionError(f"mse_cluster two-process: {ex}")
        ts, resps = _warm(torch, broker, sql, args.iters)
        out["two_process"] = {
            "child_start_s": start_s, "cold_ms": cold_ms,
            "broker_p50_ms": float(np.median(ts)), "warm_runs": len(ts),
            "exchange": _exchange_view(resps[-1]),
            "stages": _stage_summary(resps)}
        store.set("/CONTROL/STOP/Remote_0", True)
        child.join(timeout=60)
        out["two_process"]["child_exitcode"] = child.exitcode
        if child.exitcode != 0:
            raise AssertionError(f"mse_cluster: the child server exited "
                                 f"{child.exitcode}")
        child = None

        # a crash: Server_1's endpoint dies, its live-instance entry stays
        servers[1]._rpc.close()
        t0 = time.perf_counter()
        resp = broker.execute_sql("SET timeoutMs = 30000; "
                                  + MSE_CLUSTER_QUERIES["q8"])
        crash_ms = (time.perf_counter() - t0) * 1e3
        left = {s.instance_id: sorted(s.mse_worker.boxes.open_queries())
                for s in servers}
        left["broker"] = sorted(broker.mse_dispatcher.boxes.open_queries())
        if resp.result_table is not None or not resp.exceptions \
                or crash_ms > 30000 or any(left.values()):
            raise AssertionError(f"mse_cluster crash: {resp.exceptions} in "
                                 f"{crash_ms} ms, stores {left}")
        out["crash"] = {"ms": crash_ms, "exception": resp.exceptions[0][:120],
                        "open_mailboxes": left}
    finally:
        faults.FAULTS.reset()
        if child is not None:
            try:
                store.set("/CONTROL/STOP/Remote_0", True)
            except Exception:
                pass
            child.join(timeout=30)
            if child.is_alive():
                child.kill()
                child.join(timeout=10)
        _cluster_stop(cluster)
        store_server.close()
        _set_env("PINOT_TPU_DEVICE_JOIN", prev_join)
        out["gc_gen2_collections"] = gc.get_stats()[2]["collections"] - gen2
        gc.unfreeze()
    parity = {}
    for k, rec in enumerate(recorded["mse_agg"][0]):
        parity[f"limb_sums/mse_cluster_agg/server{k}"] = check_equal(
            torch, f"limb_sums mse_cluster mse_agg, server {k}",
            mxu.limb_sums(*rec), mxu.limb_sums_plain(*rec))
    for k, rec in enumerate(recorded["mse_agg_solo"][1]):
        parity[f"fused_limb_sums/mse_cluster_agg_solo/launch{k}"] = \
            check_equal(torch, f"fused_limb_sums mse_cluster mse_agg_solo, "
                        f"launch {k}", fg.fused_limb_sums(*rec),
                        fg.fused_limb_sums_plain(*rec))
    out["parity"] = parity
    del cluster, servers, broker
    gc.collect()
    torch.cuda.empty_cache()
    emit(dict({"phase": "mse_cluster",
               "seconds": time.perf_counter() - t_phase,
               "budget_s": MSE_CLUSTER_BUDGET_S,
               "note": "the servers and the broker share one process and "
                       "its GIL, but for the child server of two_process"},
              **out))
    return {"a_recs": recorded["mse_agg"][0],
            "a_launches": out["queries"]["mse_agg"]["launches"]["limb_sums"],
            "a_err": max(v for k, v in parity.items()
                         if k.startswith("limb_sums/")),
            "b_recs": recorded["mse_agg_solo"][1],
            "b_launches": out["queries"]["mse_agg_solo"]["launches"][
                "fused_limb_sums"],
            "b_err": max(v for k, v in parity.items()
                         if k.startswith("fused_limb_sums/"))}


# phase `admission_tiers`: the broker's admission layer and the servers'
# tiered storage on the card
ADMISSION_TIERS_BUDGET_S = 60.0
ADMISSION_CLIENTS = 16
ADMISSION_ROUNDS = 4  # queries a closed-loop client sends
ADMISSION_MAX_INFLIGHT = 2
ADMISSION_MAX_QUEUED = 2
GATE_ADMITS = 20_000  # admit() calls timed alone for the gate's cost
QUOTA_QPS = 5
# q8's burst admits one statement: its 5 admitted pair joins took 9.7 to
# 11.2 s at once (host-bound under one GIL); one shows the quota in front
# of the cluster MSE's dispatch as well (cut for phase operations)
QUOTA_QPS_Q8 = 1
QUOTA_BURST = 20
CURSOR_PAGE = 1000
# sel_limit at ten pages of CURSOR_PAGE rows
SEL_LIMIT_10K = QUERIES["sel_limit"].replace("LIMIT 1000", "LIMIT 10000")
STREAM_SQL = QUERIES["sel_limit"].replace("LIMIT 1000", "LIMIT 100")
HEDGE_DELAY_S = 0.25
HEDGE_MS = 20.0
HEDGE_ITERS = 5  # 10 before phase `timeseries` joined the run
# each tiered server's budget: its smallest segment directory times this,
# so converge keeps one of its two segments and demotes the other to cold
TIER_BUDGET_SEGMENTS = 1.5
TIER_WAIT_S = 120.0  # the longest a repair or a prefetch warm may take


def _wait_for(predicate, timeout_s: float, what: str) -> float:
    """Wait for `predicate` (bounded); returns the seconds it took."""
    t0 = time.monotonic()
    while not predicate():
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError(f"admission_tiers: timed out waiting for "
                                 f"{what}")
        time.sleep(0.01)
    return time.monotonic() - t0


def _tar_segment(tmp, name) -> str:
    """A segment directory as a tarball beside it (the deep store's form),
    gzip at level 0 (stored blocks: no compression work), copied in 16 MiB
    chunks so the thread holds the GIL for little of it."""
    import tarfile

    tar = f"{tmp}/{name}.tar.gz"
    with tarfile.open(tar, "w:gz", compresslevel=0) as tf:
        tf.copybufsize = 16 << 20
        tf.add(f"{tmp}/{name}", arcname=name)
    return tar


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def phase_admission_tiers(args, torch, tmp, schema, expected, _cuda, mxu, fg,
                          card) -> dict:
    """The broker's admission layer (cluster/quota.py, cluster/workload.py)
    and the servers' tiered storage (storage/) on the card, on clusters of
    their own over phase `data`'s `ssb` directories (4 x 2^23 rows).

    Replication 2, plain directories: 16 closed-loop clients send
    q2_family to a broker whose gate admits 2 and queues 2 (every answer
    the oracle's rows or a rejection, the queriesRejected meter equal to
    the rejections, the in-flight gauge never above 2; admitted p50 / p99
    and the queue wait; the gate's own cost per admit); under a burst of
    20 a QPS quota of 5 admits 5 q2_family and one of 1 admits 1 q8
    through the cluster MSE; sel_limit through a cursor in pages of 1000 (and a 10,000-row
    variant in ten pages) equals the full response; a LIMIT 100 selection
    streams and stops early; q2_family with the first server.query RPC of
    each query delayed 250 ms, without hedging and with hedge_ms = 20
    (rows bit-identical, hedges and wins, the loser's cancel at its
    server).

    Replication 1, tarballs: each server's tier holds 1.5 of its smallest
    segments, so it keeps one of its two and demotes the other cold. The
    first q2_family warms the cold ones (coldLoadMs) and launches kernel A
    over each server's family; an eviction pass demotes one segment a
    server (the card's allocated bytes fall by its plane bytes) and the
    next query fetches it again; a `storage.fetch` corrupt fault
    quarantines a segment, the repair fetches a fresh copy and the next
    query is exact; a StoragePrefetcher fed by the broker's beacon warms
    a cold segment a server into headroom (demoting the other: the tier
    holds one) and replays the AOT records of phase `flight_recorder`;
    mse_agg's leaves warm the demoted ones; before the prefetch, q2 under
    segmentBatch = false launches kernel B on every segment the queries
    warmed; the disk stays within the budget plus one segment at every
    check."""
    from pinot_tpu_torch.cluster import (Broker, ClusterController,
                                         PropertyStore, ServerInstance)
    from pinot_tpu_torch.cluster.quota import (AdmissionController,
                                               QueryQuotaManager)
    from pinot_tpu_torch.engine import aot_cache
    from pinot_tpu_torch.spi import faults
    from pinot_tpu_torch.spi.metrics import (BROKER_METRICS, SERVER_METRICS,
                                             BrokerMeter, BrokerTimer,
                                             ServerMeter, ServerTimer)
    from pinot_tpu_torch.storage import StoragePrefetcher

    t_phase = time.perf_counter()
    rows = args.rows_per_segment
    sql, want = QUERIES["q2_family"], expected["q2_family"]
    out = {"card": card}
    recs = {}
    # every earlier phase ran brokers with hedging off (the default)
    out["hedges_before_phase"] = BROKER_METRICS.meter_count(
        BrokerMeter.HEDGED_REQUESTS)
    if out["hedges_before_phase"]:
        raise AssertionError("admission_tiers: a default broker hedged "
                             f"{out['hedges_before_phase']} requests")
    gc.collect()
    gc.freeze()
    # the tiered part's tarballs are written in the background meanwhile
    names = [f"ssb_{i}" for i in range(args.segments)]
    tar_pool = ThreadPoolExecutor(len(names))
    tar_jobs = [tar_pool.submit(_tar_segment, tmp, n) for n in names]
    t_tar = time.perf_counter()
    cluster = _cluster_start(torch, tmp, schema, args.segments, rows, 2)
    _, _, servers, base = cluster
    store = cluster[0]
    brokers = [base]
    try:
        # both replicas' planes on the card before anything is timed
        for srv in servers:
            srv.executor.execute_sql(sql.replace("FROM ssb",
                                                 "FROM ssb_OFFLINE"))
        torch.cuda.synchronize()

        # -- 1: the admission gate under 16 closed-loop clients ----------
        adm = Broker(store, max_inflight=ADMISSION_MAX_INFLIGHT,
                     max_queued=ADMISSION_MAX_QUEUED)
        brokers.append(adm)
        _rows_equal("admission warm", adm.execute_sql(sql), want, False)
        rejected0 = BROKER_METRICS.meter_count(BrokerMeter.QUERIES_REJECTED)
        waits0 = BROKER_METRICS.timer_stats(BrokerTimer.ADMISSION_WAIT_MS)[0]
        peak, stop = [0.0], threading.Event()

        def sample():
            while not stop.is_set():
                peak[0] = max(peak[0], BROKER_METRICS.gauge_value(
                    "brokerQueriesInflight"))
                time.sleep(0.0005)

        answers, lock = [], threading.Lock()
        barrier = threading.Barrier(ADMISSION_CLIENTS)

        def client():
            barrier.wait()
            for _ in range(ADMISSION_ROUNDS):
                t0 = time.perf_counter()
                r = adm.execute_sql(sql)
                ms = (time.perf_counter() - t0) * 1e3
                with lock:
                    answers.append((r, ms))

        sampler = threading.Thread(target=sample)
        sampler.start()
        t_run = time.perf_counter()
        threads = [threading.Thread(target=client)
                   for _ in range(ADMISSION_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        run_s = time.perf_counter() - t_run
        stop.set()
        sampler.join()
        admitted, rejected = [], 0
        for r, ms in answers:
            if r.query_rejected and r.exceptions and \
                    r.exceptions[0].startswith("QueryRejectedError") and \
                    r.result_table is None:
                rejected += 1
                continue
            _rows_equal("admission", r, want, False)
            admitted.append(ms)
        meter = BROKER_METRICS.meter_count(BrokerMeter.QUERIES_REJECTED) \
            - rejected0
        if meter != rejected or peak[0] > ADMISSION_MAX_INFLIGHT \
                or not admitted:
            raise AssertionError(
                f"admission: {rejected} rejected, the meter {meter}; the "
                f"in-flight gauge peaked at {peak[0]}; "
                f"{len(admitted)} admitted")
        gate = AdmissionController(max_inflight=ADMISSION_MAX_INFLIGHT)
        t0 = time.perf_counter()
        for _ in range(GATE_ADMITS):
            with gate.admit(timeout_s=1.0):
                pass
        gate_us = (time.perf_counter() - t0) / GATE_ADMITS * 1e6
        out["admission"] = {
            "clients": ADMISSION_CLIENTS, "queries": len(answers),
            "max_inflight": ADMISSION_MAX_INFLIGHT,
            "max_queued": ADMISSION_MAX_QUEUED,
            "admitted": len(admitted), "rejected": rejected,
            "queries_rejected_meter": meter,
            "inflight_gauge_peak": peak[0], "run_s": run_s,
            "admitted_p50_ms": float(np.percentile(admitted, 50)),
            "admitted_p99_ms": float(np.percentile(admitted, 99)),
            "queue_waits": BROKER_METRICS.timer_stats(
                BrokerTimer.ADMISSION_WAIT_MS)[0] - waits0,
            "queue_wait_p50_ms": BROKER_METRICS.timer_quantile(
                BrokerTimer.ADMISSION_WAIT_MS, 0.5),
            "queue_wait_p99_ms": BROKER_METRICS.timer_quantile(
                BrokerTimer.ADMISSION_WAIT_MS, 0.99),
            "gate_admit_us": gate_us,
            "note": "host clock; admitted ms is the client's wall time, "
                    "its queue wait included"}

        # -- 1b: QPS quotas under a burst of 20 --------------------------
        qb = Broker(store)
        brokers.append(qb)
        quota = {}
        # q8's pair join on the card, as phase mse_cluster runs it (under
        # the auto gate its 5 admitted statements join on the host at once:
        # 11.2 s on an H100 80GB HBM3 at 700 W)
        prev_join = os.environ.get("PINOT_TPU_DEVICE_JOIN")
        for qname, qsql, qwant, ordered, qps in (
                ("q2_family", sql, want, False, QUOTA_QPS),
                ("q8", MSE_QUERIES["q8"], expected["q8"], True,
                 QUOTA_QPS_Q8)):
            _set_env("PINOT_TPU_DEVICE_JOIN", "1" if qname == "q8"
                     else prev_join)
            qb.quota = QueryQuotaManager()
            qb.quota.set_qps_limit("ssb", qps)
            results = []
            burst = threading.Barrier(QUOTA_BURST)

            def fire():
                burst.wait()
                r = qb.execute_sql(qsql)
                with lock:
                    results.append(r)

            t0 = time.perf_counter()
            threads = [threading.Thread(target=fire)
                       for _ in range(QUOTA_BURST)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            burst_s = time.perf_counter() - t0
            ok = [r for r in results if not r.exceptions]
            over = [r for r in results if r.exceptions and r.exceptions[0]
                    .startswith("QueryQuotaExceededError")]
            if len(ok) != qps or len(over) != QUOTA_BURST - qps:
                raise AssertionError(
                    f"quota {qname}: {len(ok)} answered, {len(over)} over "
                    f"quota of {QUOTA_BURST}: "
                    f"{[r.exceptions[:1] for r in results]}")
            for r in ok:
                _rows_equal(f"quota {qname}", r, qwant, ordered)
            quota[qname] = {"qps": qps, "answered": len(ok),
                            "over_quota": len(over), "burst_s": burst_s,
                            "exception": over[0].exceptions[0][:80]}
        _set_env("PINOT_TPU_DEVICE_JOIN", prev_join)
        out["quota"] = dict(quota, burst=QUOTA_BURST,
                            q8_pair_join="PINOT_TPU_DEVICE_JOIN=1")

        # -- 2: cursors and streaming ------------------------------------
        cb = Broker(store)
        brokers.append(cb)
        cursors = {}
        for qname, qsql in (("sel_limit", QUERIES["sel_limit"]),
                            ("sel_limit_10k", SEL_LIMIT_10K)):
            full = cb.execute_sql(qsql)
            if full.exceptions:
                raise AssertionError(f"cursor {qname}: {full.exceptions}")
            if qname == "sel_limit":
                _rows_equal("cursor sel_limit", full, expected["sel_limit"],
                            "sel_limit" in ORDERED)
            page = cb.execute_sql_cursor(qsql, num_rows=CURSOR_PAGE)
            pages = [page]
            while page["offset"] + page["numRows"] < page["totalRows"]:
                page = cb.fetch_cursor(page["cursorId"],
                                       page["offset"] + CURSOR_PAGE,
                                       CURSOR_PAGE)
                pages.append(page)
            got = [r for p in pages for r in p["resultTable"]["rows"]]
            if got != [list(r) for r in full.result_table.rows]:
                raise AssertionError(f"cursor {qname}: {len(got)} paged rows "
                                     f"differ from the full response's")
            cursors[qname] = {"pages": len(pages), "rows": len(got),
                              "page_rows": CURSOR_PAGE}
        out["cursors"] = cursors
        scanned = []
        for srv in servers:
            orig = srv.executor.execute_segments

            def counting(query, segs, tracker=None, _orig=orig):
                scanned.append(len(segs))
                return _orig(query, segs, tracker=tracker)

            srv.executor.execute_segments = counting
        try:
            t0 = time.perf_counter()
            pages = list(cb.execute_sql_stream(STREAM_SQL))
            stream_ms = (time.perf_counter() - t0) * 1e3
        finally:
            for srv in servers:
                del srv.executor.execute_segments
        streamed = sum(len(p.rows) for p in pages)
        if streamed != 100 or sum(scanned) >= args.segments:
            raise AssertionError(f"stream: {streamed} rows in {len(pages)} "
                                 f"pages, {sum(scanned)} of {args.segments} "
                                 "segments read")
        out["stream"] = {"limit": 100, "pages": len(pages), "rows": streamed,
                         "segments_read": sum(scanned),
                         "segments_routed": args.segments, "ms": stream_ms}

        # -- 3: hedging ----------------------------------------------------
        # round-robin selection (each query one shard of the 4 segments, on
        # the replicas in turn); before each query the fault is armed anew
        # to delay its first server.query RPC, the primary's
        plain = Broker(store, adaptive_selection=False)
        hedged = Broker(store, adaptive_selection=False, hedge_ms=HEDGE_MS)
        brokers += [plain, hedged]
        cancels = {srv.instance_id: [] for srv in servers}
        handlers = {srv.instance_id: srv._rpc.handler for srv in servers}
        for srv in servers:
            orig = srv._rpc.handler

            def record(request, _inst=srv.instance_id, _orig=orig):
                if request.get("type") == "cancel":
                    cancels[_inst].append(request["queryId"])
                return _orig(request)

            srv._rpc.handler = record
        plain_ms, hedged_ms, hedge_runs = [], [], []
        plain_rows = None
        for r_ in range(HEDGE_ITERS):
            faults.FAULTS.reset()
            faults.FAULTS.arm("server.query", kind="delay",
                              delay_s=HEDGE_DELAY_S, schedule=frozenset({0}))
            t0 = time.perf_counter()
            r = plain.execute_sql(sql)
            torch.cuda.synchronize()
            plain_ms.append((time.perf_counter() - t0) * 1e3)
            if r.exceptions or r.num_hedged_requests:
                raise AssertionError(f"hedge off: {r.exceptions}, "
                                     f"{r.num_hedged_requests} hedges")
            rows_ = [list(x) for x in r.result_table.rows]
            if plain_rows is None:
                plain_rows = rows_
                _rows_equal("unhedged", r, want, False)
            elif rows_ != plain_rows:
                raise AssertionError("unhedged runs differ in their rows")
        _cuda.reset_launches()
        launches_h = []
        for r_ in range(HEDGE_ITERS):
            faults.FAULTS.reset()
            faults.FAULTS.arm("server.query", kind="delay",
                              delay_s=HEDGE_DELAY_S, schedule=frozenset({0}))
            before = _cuda.LAUNCHES["limb_sums"]
            with recording(mxu, "limb_sums") as a_calls:
                t0 = time.perf_counter()
                r = hedged.execute_sql(sql)
                torch.cuda.synchronize()
                hedged_ms.append((time.perf_counter() - t0) * 1e3)
            launches_h.append(_cuda.LAUNCHES["limb_sums"] - before)
            if r.exceptions or [list(x) for x in r.result_table.rows] \
                    != plain_rows:
                raise AssertionError(f"hedged rows differ from the "
                                     f"unhedged: {r.exceptions}")
            hedge_runs.append((r.query_id, r.num_hedged_requests,
                               r.num_hedge_wins,
                               {w["server"] for w in r.wire_stats or []}))
            recs["hedged"] = list(a_calls)
        faults.FAULTS.reset()
        # the losers' cancels land off the winners' threads
        _wait_for(lambda: all(
            any(q.startswith(f"{qid}:") for v in cancels.values() for q in v)
            for qid, h, w, _ in hedge_runs if w), 10.0, "hedge cancels")
        for srv in servers:
            srv._rpc.handler = handlers[srv.instance_id]
        losers_ok = all(
            not any(q.startswith(f"{qid}:") for q in cancels[inst])
            for qid, _, _, winners in hedge_runs for inst in winners)
        hedges = sum(h for _, h, _, _ in hedge_runs)
        wins = sum(w for _, _, w, _ in hedge_runs)
        if hedges < 1 or wins < 1 or not losers_ok:
            raise AssertionError(f"hedging: {hedges} hedges, {wins} wins, "
                                 f"cancels {cancels}")
        out["hedging"] = {
            "delay_ms": HEDGE_DELAY_S * 1e3, "hedge_ms": HEDGE_MS,
            "iters": HEDGE_ITERS,
            "unhedged_p50_ms": float(np.median(plain_ms)),
            "unhedged_p99_ms": float(np.percentile(plain_ms, 99)),
            "hedged_p50_ms": float(np.median(hedged_ms)),
            "hedged_p99_ms": float(np.percentile(hedged_ms, 99)),
            "hedged_requests": hedges, "hedge_wins": wins,
            "cancels_at_losers": sum(map(len, cancels.values())),
            "launches_a_hedged_query": launches_h,
            "rows_bit_identical": True,
            "note": "each query's first server.query RPC (its primary's) "
                    "delayed; host clock"}
        recs["hedged_launches"] = launches_h[-1]
    finally:
        faults.FAULTS.reset()
        for b in brokers:
            b.close()
        _cluster_stop(cluster)
        # no tar thread outlives a failure of the parts above
        tar_pool.shutdown(wait=True)
    del cluster, servers, base, brokers
    gc.collect()
    torch.cuda.empty_cache()

    # -- 4: tiered storage ---------------------------------------------
    t_wait = time.perf_counter()
    tars = [job.result() for job in tar_jobs]
    tar_pool.shutdown()
    seg_bytes = {n: _dir_bytes(f"{tmp}/{n}") for n in names}
    budget = TIER_BUDGET_SEGMENTS * min(seg_bytes.values())
    bound_bytes = budget + max(seg_bytes.values())
    tier = {"tar_wait_s": time.perf_counter() - t_wait,
            "tar_since_phase_start_s": time.perf_counter() - t_tar,
            "segment_bytes": seg_bytes, "budget_bytes": int(budget)}
    store = PropertyStore()
    ctl = ClusterController(store)
    servers = [ServerInstance(store, f"Server_{i}", device=DEVICE,
                              local_storage_mb=budget / (1 << 20))
               for i in range(CLUSTER_SERVERS)]
    broker = Broker(store)
    disk = []

    def disk_check(step):
        used = {srv.instance_id: srv._tier.stats()["bytesUsed"]
                for srv in servers}
        disk.append(max(used.values()))
        if max(used.values()) > bound_bytes:
            raise AssertionError(f"tier {step}: {used} bytes on disk, the "
                                 f"budget {budget} plus one segment")

    def inventory():
        return {srv.instance_id: srv.debug_storage()["tables"].get(
            "ssb_OFFLINE", {}) for srv in servers}

    def evict_pass():
        # the pass every tier fetch runs: demote the least recently used
        # unpinned copies until the tier is within its budget
        for srv in servers:
            srv._tier._make_room()

    def tier_query(label, qsql, qwant, ordered, kernel=None, count=None):
        cold0 = SERVER_METRICS.meter_count(ServerMeter.SEGMENT_COLD_LOADS)
        _cuda.reset_launches()
        with recording(mxu, "limb_sums") as a_calls, \
                recording(fg, "fused_limb_sums") as b_calls:
            t0 = time.perf_counter()
            r = broker.execute_sql(qsql)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        made = dict(_cuda.LAUNCHES)
        if r.exceptions or r.partial_result:
            raise AssertionError(f"tier {label}: {r.exceptions}")
        _rows_equal(f"tier {label}", r, qwant, ordered)
        if kernel is not None and made[kernel] != count:
            raise AssertionError(f"tier {label}: {made} launches, {count} "
                                 f"of {kernel} expected")
        disk_check(label)
        return r, ms, made, list(a_calls), list(b_calls), \
            SERVER_METRICS.meter_count(ServerMeter.SEGMENT_COLD_LOADS) - cold0

    try:
        t0 = time.perf_counter()
        for srv in servers:
            srv.start()
        ctl.add_schema(schema.to_json())
        table = ctl.create_table({"tableName": "ssb", "replication": 1})
        for name, tar in zip(names, tars):
            ctl.add_segment(table, name, {"location": tar, "numDocs": rows})
        tier["converge_s"] = time.perf_counter() - t0
        inv = inventory()
        if any(len(v.get("resident", [])) != 1 or len(v.get("cold", [])) != 1
               for v in inv.values()):
            raise AssertionError(f"tier converge: {inv}")
        view = store.get("/EXTERNALVIEW/ssb_OFFLINE") or {}
        if sorted(view) != names or any(
                st != "ONLINE" for m in view.values() for st in m.values()):
            raise AssertionError(f"tier converge: external view {view}")
        tier["converged"] = inv
        disk_check("converge")

        # the first query warms each server's cold segment
        timer0 = SERVER_METRICS.timer_stats(ServerTimer.COLD_LOAD_MS)[0]
        r, cold_ms, made, a_calls, _, cold = tier_query(
            "cold first query", sql, want, False, "limb_sums",
            CLUSTER_SERVERS)
        if cold != CLUSTER_SERVERS or r.cold_segments_warming or \
                any(c[0].shape[0] != 2 for c in a_calls):
            raise AssertionError(f"tier cold: {cold} cold loads, "
                                 f"{r.cold_segments_warming} still warming")
        recs["cold"] = a_calls
        tier["cold_query"] = {
            "ms": cold_ms, "cold_loads": cold,
            "cold_load_ms_timings": SERVER_METRICS.timer_stats(
                ServerTimer.COLD_LOAD_MS)[0] - timer0,
            "cold_load_ms_p50": SERVER_METRICS.timer_quantile(
                ServerTimer.COLD_LOAD_MS, 0.5),
            "launches": made}
        warm = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            r = broker.execute_sql(sql)
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0) * 1e3)
        _rows_equal("tier warm", r, want, False)
        tier["warm_p50_ms"] = float(np.median(warm))

        # an eviction pass demotes a segment a server; its planes leave the
        # card, and the next query fetches it again onto fresh planes
        views = {}
        for srv in servers:
            cache = srv.executor.executor.cache
            views[srv.instance_id] = {v.segment.name: v.nbytes()
                                      for v in cache._views.values()}
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        evict_pass()
        gc.collect()
        torch.cuda.synchronize()
        freed = before - torch.cuda.memory_allocated()
        demoted = {srv.instance_id: srv.debug_storage()["tables"][
            "ssb_OFFLINE"]["cold"] for srv in servers}
        plane_bytes = sum(views[i][n] for i, ns in demoted.items()
                          for n in ns)
        left = [n for srv in servers for n in demoted[srv.instance_id]
                if n in srv.executor.executor.cache.segment_names()]
        if freed < plane_bytes or left or not plane_bytes:
            raise AssertionError(f"tier evict: {freed} bytes freed on the "
                                 f"card, the demoted planes {plane_bytes}; "
                                 f"left in the cache {left}")
        r, ms, made, a_calls, _, cold = tier_query(
            "fetch again", sql, want, False, "limb_sums", CLUSTER_SERVERS)
        if cold != CLUSTER_SERVERS:
            raise AssertionError(f"tier fetch again: {cold} cold loads")
        recs["refetch"] = a_calls
        tier["evict_fetch_again"] = {
            "demoted": demoted, "plane_bytes": plane_bytes,
            "card_bytes_freed": freed, "fetch_again_ms": ms,
            "cold_loads": cold}

        # a corrupt cold fetch: quarantine, then the repair's fresh copy
        evict_pass()
        q0 = SERVER_METRICS.meter_count(ServerMeter.SEGMENTS_QUARANTINED)
        rep0 = SERVER_METRICS.meter_count(ServerMeter.SEGMENT_REPAIRS)
        faults.FAULTS.arm("storage.fetch", kind="corrupt", times=1)
        t0 = time.perf_counter()
        part = broker.execute_sql("SET allowPartialResults = true; " + sql)
        fired = faults.FAULTS.fired("storage.fetch")
        repair_s = _wait_for(lambda: SERVER_METRICS.meter_count(
            ServerMeter.SEGMENT_REPAIRS) > rep0, TIER_WAIT_S, "the repair")
        repair_ms = (time.perf_counter() - t0) * 1e3
        faults.FAULTS.reset()
        r, ms, made, a_calls, _, _ = tier_query(
            "after repair", sql, want, False, "limb_sums", CLUSTER_SERVERS)
        quarantined = SERVER_METRICS.meter_count(
            ServerMeter.SEGMENTS_QUARANTINED) - q0
        if fired != 1 or quarantined != 1:
            raise AssertionError(f"tier corrupt: {fired} faults, "
                                 f"{quarantined} quarantined")
        recs["repaired"] = a_calls
        tier["corrupt_repair"] = {
            "first_query_partial": part.partial_result,
            "first_query_exceptions": [e[:80] for e in part.exceptions],
            "quarantined": quarantined,
            "repairs": SERVER_METRICS.meter_count(
                ServerMeter.SEGMENT_REPAIRS) - rep0,
            "repair_ms": repair_ms, "repair_wait_s": repair_s,
            "next_query_ms": ms}

        # kernel B a segment over the segments the queries above warmed
        # (no eviction pass since: all four resident, over the budget)
        r, ms, made, _, b_calls, cold = tier_query(
            "q2 warmed", QUERIES["q2"], expected["q2"], False,
            "fused_limb_sums", args.segments)
        if cold:
            raise AssertionError(f"tier q2 warmed: {cold} cold loads")
        recs["q2_warmed"] = b_calls
        tier["q2_warmed"] = {"ms": ms, "cold_loads": cold, "launches": made}

        # the prefetcher, fed by the broker's beacon, warms the cold
        # segments into headroom and replays the table's AOT records; a
        # server's tier holds one of its segments, so the warm demotes the
        # other (hot too, and the least recently used)
        evict_pass()
        cold_before = {i: v["cold"] for i, v in inventory().items()}
        _set_env("PINOT_TPU_AOT_CACHE_DIR", os.path.join(tmp, "aot"))
        aot_cache.reset()
        hits0 = SERVER_METRICS.meter_count(ServerMeter.PREFETCH_HITS)
        prewarms = []
        orig_prewarm = aot_cache.prewarm_table

        def prewarm(table, *a, **kw):
            res = orig_prewarm(table, *a, **kw)
            prewarms.append((threading.current_thread().name, res))
            return res

        aot_cache.prewarm_table = prewarm
        try:
            state = broker.publish_state()
            t0 = time.perf_counter()
            nudge = StoragePrefetcher(store)()
            warm_s = _wait_for(lambda: SERVER_METRICS.meter_count(
                ServerMeter.PREFETCH_HITS) - hits0 >= CLUSTER_SERVERS
                and any(n.startswith("aot-prewarm") for n, _ in prewarms),
                TIER_WAIT_S, "the prefetch warm")
        finally:
            aot_cache.prewarm_table = orig_prewarm
            _set_env("PINOT_TPU_AOT_CACHE_DIR", None)
            aot_cache.reset()
        inv = inventory()
        if nudge["nudged"] != ["ssb"] or any(
                v["resident"] != cold_before[i] for i, v in inv.items()):
            raise AssertionError(f"tier prefetch: {nudge}, {inv}, the cold "
                                 f"segments before {cold_before}")
        disk_check("prefetch")
        loaded = sum(res.get("loaded", 0) for _, res in prewarms)
        if loaded < 1:
            raise AssertionError(f"tier prefetch: AOT prewarm {prewarms}")
        tier["prefetch"] = {
            "beacon_table_costs_ms": state["tableCostsMs"],
            "nudged": nudge["nudged"],
            "prefetch_hits": SERVER_METRICS.meter_count(
                ServerMeter.PREFETCH_HITS) - hits0,
            "warm_s": warm_s, "since_nudge_ms":
                (time.perf_counter() - t0) * 1e3,
            "warmed": cold_before,
            "aot_prewarms": len(prewarms), "aot_families_loaded": loaded,
            "hot_tables": sorted(servers[0]._tier.stats()["hotTables"])}

        # mse_agg's leaves warm the segment a server's prefetch demoted
        r, ms, made, a_calls, _, cold = tier_query(
            "mse_agg", MSE_QUERIES["mse_agg"], expected["mse_agg"], False,
            "limb_sums", CLUSTER_SERVERS)
        if cold != CLUSTER_SERVERS:
            raise AssertionError(f"tier mse_agg: {cold} cold loads")
        recs["mse_agg"] = a_calls
        tier["mse_agg"] = {"ms": ms, "cold_loads": cold, "launches": made}
        tier["disk_bytes_peak"] = max(disk)
        tier["disk_bound_bytes"] = int(bound_bytes)
        tier["storage"] = {srv.instance_id: srv._tier.stats()
                           for srv in servers}
        out["tiers"] = tier
    finally:
        faults.FAULTS.reset()
        for srv in servers:
            if srv._started:
                srv.stop()
        broker.close()
        for tar in tars:
            os.remove(tar)
        gc.unfreeze()
    del servers, broker
    gc.collect()
    torch.cuda.empty_cache()

    parity = {}
    for label in ("cold", "refetch", "repaired", "hedged", "mse_agg"):
        parity[label] = max(check_equal(
            torch, f"limb_sums admission_tiers {label}, launch {k}",
            mxu.limb_sums(*rec), mxu.limb_sums_plain(*rec))
            for k, rec in enumerate(recs[label]))
    parity["q2_warmed"] = max(check_equal(
        torch, f"fused_limb_sums admission_tiers q2_warmed, segment {k}",
        fg.fused_limb_sums(*rec), fg.fused_limb_sums_plain(*rec))
        for k, rec in enumerate(recs["q2_warmed"]))
    out["parity"] = parity
    seconds = time.perf_counter() - t_phase
    emit(dict({"phase": "admission_tiers", "seconds": seconds,
               "budget_s": ADMISSION_TIERS_BUDGET_S,
               "note": "one process: the servers and the brokers share its "
                       "GIL and its card"}, **out))
    return {"recs": recs, "parity": parity}


OPERATIONS_BUDGET_S = 40.0
OPS_P50_ITERS = 3  # 5 before phase `timeseries` joined the run
OPS_STRAGGLE_S = 0.25  # the server.query delay on the straggler
OPS_STRAGGLE_QUERIES = 8
OPS_WAIT_S = 120.0  # the longest a move, a repair or a swap may take
OPS_PRINCIPALS = [
    {"username": "ops", "password": "ops-secret"},
    {"username": "scoped", "password": "scoped-secret",
     "tables": ["other"]}]
OPS_BROKER_DEBUG = ("/debug/queries", "/debug/cache", "/debug/servers",
                    "/debug/workload", "/debug/traces", "/debug/compiles",
                    "/debug/ledger", "/debug/alerts")
OPS_CONTROLLER_DEBUG = ("/debug/cluster", "/debug/store", "/debug/rebalance")
OPS_SERVER_DEBUG = ("/debug/tables/ssb_OFFLINE", "/debug/segments",
                    "/debug/queries", "/debug/compiles", "/debug/status",
                    "/debug/storage")
PROM_LINE = re.compile(r"(#.*|[A-Za-z_:][A-Za-z0-9_:]*(\{[^}]*\})? "
                       r"[-+0-9.eEinfNa]+)")


def _http(url: str, body=None, method=None, headers=None):
    """(status, parsed JSON or text) of one loopback HTTP request."""
    data = None if body is None else json.dumps(body).encode()
    hdrs = dict(headers or {})
    if data is not None:
        hdrs["Content-Type"] = "application/json"
    req = urllib.request.Request(url, data=data, method=method, headers=hdrs)
    try:
        with urllib.request.urlopen(req, timeout=OPS_WAIT_S) as r:
            code, raw, ctype = r.status, r.read(), r.headers.get(
                "Content-Type", "")
    except urllib.error.HTTPError as e:
        code, raw, ctype = e.code, e.read(), e.headers.get("Content-Type",
                                                           "")
    text = raw.decode("utf-8")
    return code, (json.loads(text) if "json" in ctype else text)


def _prometheus_samples(url: str, role: str) -> int:
    """GET /metrics must parse as Prometheus text exposition; returns the
    number of samples."""
    code, text = _http(url + "/metrics")
    lines = [x for x in text.splitlines() if x]
    if code != 200 or not lines or not all(PROM_LINE.fullmatch(x)
                                           for x in lines):
        raise AssertionError(f"operations /metrics {role}: {code}, "
                             f"{len(lines)} lines")
    return sum(not x.startswith("#") for x in lines)


def _basic(user: str, password: str) -> dict:
    return {"Authorization": "Basic " + base64.b64encode(
        f"{user}:{password}".encode()).decode()}


def _rest_rows_equal(label, body, want) -> None:
    _rows_equal(label, SimpleNamespace(result_table=SimpleNamespace(
        rows=body["resultTable"]["rows"])), want, False)


def _renamed_copy(src: str, dst: str, name: str) -> str:
    """A copy of a segment directory under another segment name: the same
    rows and data bytes (the crc covers the data alone)."""
    shutil.copytree(src, dst)
    meta_path = os.path.join(dst, "metadata.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["segmentName"] = name
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    return dst


@contextlib.contextmanager
def _rest_load(url, sql, want):
    """A client sending `sql` over REST while the block runs; each answer
    is held against the oracle. Yields the count of answers so far (a
    list of one int)."""
    stop, answers, errors = threading.Event(), [0], []

    def run():
        while not stop.is_set():
            code, body = _http(url + "/query/sql", {"sql": sql})
            try:
                if code != 200:
                    raise AssertionError(f"{code} {str(body)[:200]}")
                _rest_rows_equal("REST client", body, want)
            except AssertionError as e:
                errors.append(str(e)[:200])
                return
            answers[0] += 1

    t = threading.Thread(target=run, name="ops-rest-client")
    t.start()
    try:
        yield answers
    finally:
        stop.set()
        t.join(OPS_WAIT_S)
    if errors or not answers[0]:
        raise AssertionError(f"operations REST client: {answers[0]} "
                             f"answers, {errors[:1]}")


def phase_operations(args, torch, tmp, schema, expected, _cuda, mxu, fg,
                     card) -> dict:
    """The operations layer (cluster/rest.py, auth.py, rebalance.py,
    periodic.py) on the card, over loopback HTTP, on a cluster of its own
    over phase `data`'s `ssb` directories (4 x 2^23 rows): 2 card servers
    at replication 1 (each a family of 2), a broker, a controller and
    their REST servers; a third card server joins for the rebalance.

    REST serving: q2_family (kernel A once a server) and q2 (kernel B a
    segment) over POST /query/sql with the oracle's rows, every count set
    to 0 just before each; the REST p50 of q2_family beside
    Broker.execute_sql's; a quota of 1 qps rejects the second query (500,
    QueryQuotaExceededError, as the JAX REST answers); a query the
    admission gate sheds answers 429; BasicAuth with two principals
    answers 401 without credentials and 403 on a table outside the grant;
    /metrics of each role parses as Prometheus text; every /debug route
    answers 200 with JSON.

    Rebalance: the joiner starts and POST /tables/ssb/rebalance moves a
    segment onto it while a client sends q2_family over REST (every answer
    the oracle's; no segment below one routable replica); the source's
    device cache lets the moved planes go (bytes freed). A drain of
    Server_0 moves its segments onto the other two with the first
    destination fetch corrupted by a `rebalance.move` fault: the verifying
    loader quarantines it, the SegmentIntegrityChecker's /REPAIRS/ nudge
    repairs it and the job ends DONE; q2_family then launches kernel A
    over the destination's family of 2. Lineage: ssb_0 is replaced by a
    renamed copy (start_replace, the copy added, end_replace) under a REST
    client: the rows are the oracle's in progress and after (counted
    once), and the old segment's planes leave its server. Fleet health:
    a scrape of the 3 servers (each server's device bytes equal to its
    cache's), then with Server_1's server.query RPCs delayed the next
    scrape flags it `straggler`, served by GET /debug/cluster. Scheduler:
    build_default_scheduler's tasks, each run once and timed."""
    from pinot_tpu_torch.cluster import (Broker, ClusterController,
                                         PropertyStore, ServerInstance)
    from pinot_tpu_torch.cluster.auth import BasicAuthAccessControl
    from pinot_tpu_torch.cluster.periodic import (ClusterHealthChecker,
                                                  SegmentIntegrityChecker,
                                                  SegmentLineageManager,
                                                  build_default_scheduler)
    from pinot_tpu_torch.cluster.quota import AdmissionController
    from pinot_tpu_torch.cluster.rebalance import SegmentRebalancer
    from pinot_tpu_torch.cluster.rest import (BrokerRestServer,
                                              ControllerRestServer,
                                              ServerRestServer)
    from pinot_tpu_torch.spi import faults

    t_phase = time.perf_counter()
    rows = args.rows_per_segment
    sql, want = QUERIES["q2_family"], expected["q2_family"]
    out = {"card": card}
    recs = {}
    launches = {}
    store = PropertyStore()
    ctl = ClusterController(store)
    # automatic repair off: the integrity checker's nudge repairs
    servers = [ServerInstance(store, f"Server_{i}", device=DEVICE,
                              auto_repair=False)
               for i in range(CLUSTER_SERVERS)]
    broker = Broker(store)
    rests = []
    copy_dir = f"{tmp}/ssb_0r"

    def caches():
        return {s.instance_id: s.executor.executor.cache for s in servers}

    def rest_query(label, qsql, qwant, url, per_kernel):
        """One REST query with every count set to 0 just before it; the
        launches it made must be `per_kernel` exactly."""
        _cuda.reset_launches()
        with recording(mxu, "limb_sums") as a_calls, \
                recording(fg, "fused_limb_sums") as b_calls:
            t0 = time.perf_counter()
            code, body = _http(url + "/query/sql", {"sql": qsql})
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        made = dict(_cuda.LAUNCHES)
        if code != 200:
            raise AssertionError(f"operations {label}: {code} {body}")
        _rest_rows_equal(f"operations {label}", body, qwant)
        if made != per_kernel:
            raise AssertionError(f"operations {label}: launches {made}, "
                                 f"{per_kernel} expected")
        launches[label] = made
        return ms, list(a_calls), list(b_calls)

    def per_server_kernels(table):
        """Kernel A once a server routing 2 or more segments, kernel B a
        segment on a server routing 1 (no family to batch)."""
        routed = {}
        for insts in broker.routing_table(table).values():
            routed[insts[0]] = routed.get(insts[0], 0) + 1
        return {"limb_sums": sum(1 for n in routed.values() if n > 1),
                "fused_limb_sums": sum(n for n in routed.values()
                                       if n == 1)}

    try:
        t0 = time.perf_counter()
        for srv in servers:
            srv.start()
        ctl.add_schema(schema.to_json())
        table = ctl.create_table({"tableName": "ssb", "replication": 1})
        for i in range(args.segments):
            ctl.add_segment(table, f"ssb_{i}", {"location": f"{tmp}/ssb_{i}",
                                                "numDocs": rows})
        b_rest = BrokerRestServer(broker)
        c_rest = ControllerRestServer(ctl)
        rests += [b_rest, c_rest] + [ServerRestServer(s) for s in servers]
        # every server's planes on the card before anything is timed
        _rows_equal("operations warm", broker.execute_sql(sql), want, False)
        _rows_equal("operations warm q2", broker.execute_sql(QUERIES["q2"]),
                    expected["q2"], False)
        torch.cuda.synchronize()
        out["start_s"] = time.perf_counter() - t0

        # -- 1: REST serving ----------------------------------------------
        _, recs["rest_q2_family"], _ = rest_query(
            "rest_q2_family", sql, want, b_rest.url,
            {"limb_sums": CLUSTER_SERVERS, "fused_limb_sums": 0})
        _, _, recs["rest_q2"] = rest_query(
            "rest_q2", QUERIES["q2"], expected["q2"], b_rest.url,
            {"limb_sums": 0, "fused_limb_sums": args.segments})
        rest_ms, direct_ms = [], []
        for _ in range(OPS_P50_ITERS):
            t0 = time.perf_counter()
            code, body = _http(b_rest.url + "/query/sql", {"sql": sql})
            torch.cuda.synchronize()
            rest_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            r = broker.execute_sql(sql)
            torch.cuda.synchronize()
            direct_ms.append((time.perf_counter() - t0) * 1e3)
            if code != 200 or r.exceptions:
                raise AssertionError(f"operations p50: {code}, "
                                     f"{r.exceptions}")
        broker.quota.set_qps_limit("ssb", 1)
        try:
            quota = [_http(b_rest.url + "/query/sql", {"sql": sql})
                     for _ in range(2)]
        finally:
            broker.quota.set_qps_limit("ssb", None)
        if quota[0][0] != 200 or quota[1][0] != 500 or not quota[1][1][
                "exceptions"][0].startswith("QueryQuotaExceededError"):
            raise AssertionError(f"operations quota: {quota[1]}")
        saved = broker.admission
        broker.admission = AdmissionController(max_inflight=1, max_queued=0)
        try:
            with broker.admission.admit(timeout_s=5.0):
                shed = _http(b_rest.url + "/query/sql", {"sql": sql})
        finally:
            broker.admission = saved
        if shed[0] != 429 or shed[1].get("queryRejected") is not True:
            raise AssertionError(f"operations shed: {shed}")
        auth_rest = BrokerRestServer(
            broker, access_control=BasicAuthAccessControl(OPS_PRINCIPALS))
        rests.append(auth_rest)
        auth = {
            "no_credentials": _http(auth_rest.url + "/query/sql",
                                    {"sql": sql})[0],
            "ops": _http(auth_rest.url + "/query/sql", {"sql": sql},
                         headers=_basic("ops", "ops-secret"))[0],
            "scoped_table_outside_grant": _http(
                auth_rest.url + "/query/sql", {"sql": sql},
                headers=_basic("scoped", "scoped-secret"))[0],
            "health_open": _http(auth_rest.url + "/health")[0]}
        if auth != {"no_credentials": 401, "ops": 200,
                    "scoped_table_outside_grant": 403, "health_open": 200}:
            raise AssertionError(f"operations auth: {auth}")
        metrics = {role: _prometheus_samples(rest.url, role) for role, rest
                   in (("broker", b_rest), ("server", rests[2]))}
        debug = {}
        for rest, routes in ((b_rest, OPS_BROKER_DEBUG),
                             (c_rest, OPS_CONTROLLER_DEBUG),
                             (rests[2], OPS_SERVER_DEBUG)):
            for route in routes:
                code, body = _http(rest.url + route)
                ok = code == 200 and isinstance(body, (dict, list))
                # before the first scrape the controller has no snapshot
                if route == "/debug/cluster" and code == 503:
                    ok = isinstance(body, dict)
                if not ok:
                    raise AssertionError(f"operations {route}: {code}")
                debug[route] = code
        out["rest"] = {
            "q2_family_rest_p50_ms": float(np.median(rest_ms)),
            "q2_family_execute_sql_p50_ms": float(np.median(direct_ms)),
            "rest_overhead_p50_ms": float(np.median(rest_ms))
            - float(np.median(direct_ms)),
            "iters": OPS_P50_ITERS,
            "quota_1qps": [quota[0][0], quota[1][0],
                           quota[1][1]["exceptions"][0][:60]],
            "shed_status": shed[0], "auth": auth,
            "metrics_samples": metrics, "debug_routes": debug,
            "launches": {k: launches[k] for k in ("rest_q2_family",
                                                  "rest_q2")},
            "note": "host clock; REST adds the HTTP round trip and the "
                    "JSON encode and decode"}

        # -- 2: rebalance onto a joining card server ----------------------
        held = {i: (c.bytes_used(), c.segment_names())
                for i, c in caches().items()}
        joiner = ServerInstance(store, f"Server_{CLUSTER_SERVERS}",
                                device=DEVICE, auto_repair=False)
        joiner.start()
        servers.append(joiner)
        rests.append(ServerRestServer(joiner))
        stop, floor = threading.Event(), []

        def replicas():
            while not stop.is_set():
                floor.append(min(len(v) for v in
                                 broker.routing_table(table).values()))
                time.sleep(0.002)

        watcher = threading.Thread(target=replicas)
        watcher.start()
        try:
            with _rest_load(b_rest.url, sql, want) as answers:
                t0 = time.perf_counter()
                code, job = _http(c_rest.url + "/tables/ssb/rebalance", {})
                move_s = time.perf_counter() - t0
        finally:
            stop.set()
            watcher.join(OPS_WAIT_S)
        moved = [m for m in job.get("movePlan", [])
                 if joiner.instance_id in m["adds"]]
        if code != 200 or job.get("status") != "DONE" or not moved or \
                min(floor) < 1:
            raise AssertionError(f"operations rebalance: {code} {job}, "
                                 f"replica floor {min(floor, default=None)}")
        gc.collect()
        torch.cuda.synchronize()
        freed = {}
        for m in moved:
            src = m["drops"][0]
            cache = caches()[src]
            if m["segment"] in cache.segment_names() or \
                    m["segment"] not in held[src][1]:
                raise AssertionError(f"operations rebalance: {m['segment']} "
                                     f"left on {src}'s card")
            freed[src] = held[src][0] - cache.bytes_used()
        if not all(v > 0 for v in freed.values()):
            raise AssertionError(f"operations rebalance: freed {freed}")
        out["rebalance"] = {
            "moves": [{"segment": m["segment"], "from": m["drops"],
                       "to": sorted(m["adds"]),
                       "ms": m["finishedMs"] - m["startedMs"]}
                      for m in moved],
            "rest_call_s": move_s, "client_answers": answers[0],
            "replica_floor": min(floor),
            "source_card_bytes_freed": freed}

        # a drain of Server_0, its first destination fetch corrupted
        held = {i: (c.bytes_used(), c.segment_names())
                for i, c in caches().items()}
        rb = SegmentRebalancer(ctl, move_timeout_s=OPS_WAIT_S)
        checker = SegmentIntegrityChecker(store, ctl)
        faults.FAULTS.arm("rebalance.move", kind="corrupt", times=1)
        rb.plan(table, trigger="health", exclude=frozenset({"Server_0"}))
        t0 = time.perf_counter()
        t_quarantined = t_repaired = None
        nudges = []
        while time.perf_counter() - t0 < OPS_WAIT_S:
            rb.tick()
            view = store.get(f"/EXTERNALVIEW/{table}") or {}
            errored = sorted(s for s, m in view.items()
                             if "ERROR" in m.values())
            if errored and t_quarantined is None:
                t_quarantined = time.perf_counter()
                nudges.append(checker()[table]["erroredReplicas"])
            if t_quarantined is not None and t_repaired is None \
                    and not errored:
                t_repaired = time.perf_counter()
                checker()  # the repaired replica's nudge is cleared
            if rb.job(table)["status"] != "IN_PROGRESS":
                break
            time.sleep(0.005)
        job = rb.job(table)
        fired = faults.FAULTS.fired("rebalance.move")
        faults.FAULTS.reset()
        if job["status"] != "DONE" or fired != 1 or not nudges or \
                t_repaired is None or store.children(f"/REPAIRS/{table}"):
            raise AssertionError(f"operations drain: {job['status']}, "
                                 f"{fired} faults, nudges {nudges}")
        gc.collect()
        torch.cuda.synchronize()
        drained = caches()["Server_0"]
        if drained.segment_names():
            raise AssertionError(f"operations drain: Server_0 still holds "
                                 f"{drained.segment_names()}")
        kernels = per_server_kernels(table)
        if kernels != {"limb_sums": 2, "fused_limb_sums": 0}:
            raise AssertionError(f"operations drain: routing {kernels}")
        _, recs["moved"], _ = rest_query("moved", sql, want, b_rest.url,
                                         kernels)
        dst_names = caches()[joiner.instance_id].segment_names()
        if len(dst_names) != 2:
            raise AssertionError(f"operations drain: the joiner holds "
                                 f"{dst_names}")
        out["repair"] = {
            "fault": "rebalance.move corrupt, times=1", "nudged": nudges,
            "quarantine_to_online_ms": (t_repaired - t_quarantined) * 1e3,
            "job_s": time.perf_counter() - t0,
            "moves": [{"segment": m["segment"], "from": m["drops"],
                       "to": sorted(m["adds"]), "attempts": m["attempts"],
                       "ms": m["finishedMs"] - m["startedMs"]}
                      for m in job["movePlan"]],
            "drained_card_bytes_freed": held["Server_0"][0]
            - drained.bytes_used(),
            "joiner_family": sorted(dst_names)}

        # -- 3: a lineage swap under a REST client -----------------------
        t0 = time.perf_counter()
        _renamed_copy(f"{tmp}/ssb_0", copy_dir, "ssb_0r")
        copy_s = time.perf_counter() - t0
        owner = sorted(store.get(f"/IDEALSTATES/{table}")["ssb_0"])[0]
        held = caches()[owner].bytes_used()
        lineage = SegmentLineageManager(store, ctl)
        # a client runs while the copy is pushed and while the swap
        # commits; each measured query runs alone, its counts set to 0
        with _rest_load(b_rest.url, sql, want) as pushed:
            t0 = time.perf_counter()
            lid = lineage.start_replace(table, ["ssb_0"], ["ssb_0r"])
            ctl.add_segment(table, "ssb_0r", {"location": copy_dir,
                                              "numDocs": rows})
            _wait_for(lambda: (store.get(f"/EXTERNALVIEW/{table}") or {})
                      .get("ssb_0r"), OPS_WAIT_S, "the copy online")
            push_ms = (time.perf_counter() - t0) * 1e3
        in_progress = rest_query("lineage_in_progress", sql, want,
                                 b_rest.url, per_server_kernels(table))
        with _rest_load(b_rest.url, sql, want) as swapped:
            t0 = time.perf_counter()
            lineage.end_replace(table, lid)
            swap_ms = (time.perf_counter() - t0) * 1e3
            # the client answers at least once after the swap committed
            n0 = swapped[0]
            _wait_for(lambda: swapped[0] > n0 + 1, OPS_WAIT_S,
                      "an answer after the swap")
        _, recs["lineage"], recs["lineage_b"] = rest_query(
            "lineage", sql, want, b_rest.url, per_server_kernels(table))
        gc.collect()
        torch.cuda.synchronize()
        if "ssb_0" in caches()[owner].segment_names() or \
                store.get(f"/LINEAGE/{table}"):
            raise AssertionError(f"operations lineage: ssb_0 left on "
                                 f"{owner}'s card")
        out["lineage"] = {
            "copy_s": copy_s, "push_to_online_ms": push_ms,
            "end_replace_ms": swap_ms, "in_progress_ms": in_progress[0],
            "client_answers": pushed[0] + swapped[0],
            "routed": sorted(broker.routing_table(table)),
            "old_segment_card_bytes_freed": held
            - caches()[owner].bytes_used(),
            "launches": {k: launches[k] for k in ("lineage_in_progress",
                                                  "lineage")}}

        # -- 4: fleet health ----------------------------------------------
        health = ClusterHealthChecker(store, ctl)
        snap = health()
        bytes_ok = {i: snap["servers"][i]["hbm"]["hbmBytesUsed"]
                    == c.bytes_used() for i, c in caches().items()}
        if snap["fleet"]["serversReachable"] != len(servers) or \
                not all(bytes_ok.values()):
            raise AssertionError(f"operations health: {snap['fleet']}, "
                                 f"device bytes equal {bytes_ok}")
        first_scrape_ms = snap["scrapeMs"]
        # a fresh latency window: the rings hold this phase's cold queries
        for srv in servers:
            srv._query_ms.clear()
        faults.FAULTS.arm("server.query", kind="delay",
                          delay_s=OPS_STRAGGLE_S, times=None,
                          match=lambda c: c.get("instance") == "Server_1")
        try:
            for _ in range(OPS_STRAGGLE_QUERIES):
                _rows_equal("operations straggled", broker.execute_sql(sql),
                            want, False)
        finally:
            faults.FAULTS.reset()
        snap = health()
        flagged = sorted((a["type"], a["instance"]) for a in snap["anomalies"])
        code, body = _http(c_rest.url + "/debug/cluster")
        if ("straggler", "Server_1") not in flagged or code != 200 or \
                body["checkedAtMs"] != snap["checkedAtMs"]:
            raise AssertionError(f"operations straggler: {flagged}, {code}")
        out["health"] = {
            "servers": len(servers), "first_scrape_ms": first_scrape_ms,
            "scrape_ms": snap["scrapeMs"], "anomalies": flagged,
            "device_bytes": {i: c.bytes_used() for i, c in caches().items()},
            "device_bytes_match_cache": bytes_ok,
            "p99_ms": {i: s["queryLatencyMs"]["p99"]
                       for i, s in snap["servers"].items()},
            "straggle_delay_s": OPS_STRAGGLE_S}

        # -- 5: the scheduler's tasks, each run once ---------------------
        sched = build_default_scheduler(store, ctl, interval_s=3600.0)
        task_ms = {}
        for name in sorted(sched.tasks):
            t0 = time.perf_counter()
            sched.run_once(name)
            task_ms[name] = (time.perf_counter() - t0) * 1e3
        errs = {n: t.last_error for n, t in sched.tasks.items()
                if t.last_error}
        if errs or any(t.runs != 1 for t in sched.tasks.values()):
            raise AssertionError(f"operations scheduler: {errs}")
        out["scheduler"] = {"task_ms": task_ms}
        # the controller's meters exist once it has rebalanced and scraped
        out["rest"]["metrics_samples"]["controller"] = _prometheus_samples(
            c_rest.url, "controller")
    finally:
        faults.FAULTS.reset()
        for rest in rests:
            rest.close()
        for srv in servers:
            if srv._started:
                srv.stop()
        broker.close()
        shutil.rmtree(copy_dir, ignore_errors=True)
    del servers, broker
    gc.collect()
    torch.cuda.empty_cache()

    parity = {}
    for label in ("rest_q2_family", "moved", "lineage"):
        parity[label] = max(check_equal(
            torch, f"limb_sums operations {label}, launch {k}",
            mxu.limb_sums(*rec), mxu.limb_sums_plain(*rec))
            for k, rec in enumerate(recs[label]))
    for label in ("rest_q2", "lineage_b"):
        if recs[label]:
            parity[label] = max(check_equal(
                torch, f"fused_limb_sums operations {label}, launch {k}",
                fg.fused_limb_sums(*rec), fg.fused_limb_sums_plain(*rec))
                for k, rec in enumerate(recs[label]))
    out["parity"] = parity
    seconds = time.perf_counter() - t_phase
    emit(dict({"phase": "operations", "seconds": seconds,
               "budget_s": OPERATIONS_BUDGET_S,
               "note": "one process: the servers, the broker and the REST "
                       "servers share its GIL and its card; host clock"},
              **out))
    return {"recs": recs, "parity": parity, "launches": launches}


# -- phase batch_ingest: the offline data path ---------------------------------

# an analyst's nightly batch load, after Pinot's documented batch ingestion
# job spec (SegmentGenerationJobSpec: jobType SegmentCreationAndTarPush,
# inputDirURI, includeFileNamePattern, recordReaderSpec.dataFormat,
# pinotFSSpecs): one lineorder file a format lands in a deep store, one
# segment is built from each and tar-pushed to the card servers, and
# dashboards query the table. bench.py's table holds 100M rows; the phase
# takes BATCH_ROWS a file, 2^21 in all, for time. The sink: a stream
# framework's writer cutting a segment every SINK_FLUSH_ROWS
BATCH_TABLE, SINK_TABLE, SINK_TAG = "batch", "sink", "sink_tenant"
BATCH_FORMATS = ("csv.gz", "json", "avro", "thrift")
BATCH_ROWS = 1 << 19
BATCH_WORKERS = 4
BATCH_ITERS = 3  # 5 before phase `timeseries` joined the run
BATCH_WAIT_S = 120.0  # the longest the servers may take to load a push
SINK_ROWS, SINK_FLUSH_ROWS = 1 << 18, 1 << 17
# the minion's PurgeTask over the merged sink segment: about 1.1% of rows
SINK_PURGE = "lo_quantity = 7 AND lo_discount < 6"
BATCH_COLUMNS = [c for c, _ in SCHEMA_DIMS + SCHEMA_METRICS]
# Thrift's field ids, Avro's record schema
BATCH_THRIFT_IDS = {str(i + 1): c for i, c in enumerate(BATCH_COLUMNS)}
BATCH_AVRO_SCHEMA = {"type": "record", "name": "lineorder", "fields": [
    {"name": c, "type": "string" if t == "STRING" else "int"}
    for c, t in SCHEMA_DIMS + SCHEMA_METRICS]}
BATCH_QUERIES = {
    "q2_family": Q2.replace("FROM ssb", f"FROM {BATCH_TABLE}"),
    "q2": NO_BATCH + Q2.replace("FROM ssb", f"FROM {BATCH_TABLE}"),
    "count": f"SELECT COUNT(*) FROM {BATCH_TABLE}",
    "sink_q2_family": Q2.replace("FROM ssb", f"FROM {SINK_TABLE}")}


def write_batch_input(task):
    """Write one input file of phase batch_ingest (a worker of the spawn
    process pool): the k-th `rows` rows of the phase's columns in format
    `fmt`, with the port's Avro and Thrift writers; returns (path, bytes,
    seconds)."""
    from pinot_tpu_torch.plugins.inputformat import avro, thrift

    k, fmt, seed, rows, path = task
    t0 = time.perf_counter()
    cols = gen_ssb(rows * len(BATCH_FORMATS), seed)
    sl = slice(k * rows, (k + 1) * rows)
    vals = list(zip(*(cols[c][sl].tolist() for c in BATCH_COLUMNS)))
    del cols
    if fmt == "csv.gz":
        import gzip

        with gzip.open(path, "wt", compresslevel=1) as f:
            f.write(",".join(BATCH_COLUMNS) + "\n")
            f.write("\n".join(",".join(map(str, v)) for v in vals) + "\n")
    elif fmt == "json":
        with open(path, "w") as f:
            f.write("\n".join(json.dumps(dict(zip(BATCH_COLUMNS, v)))
                              for v in vals) + "\n")
    elif fmt == "avro":
        with open(path, "wb") as f:
            avro.write_avro_file(f, BATCH_AVRO_SCHEMA,
                                 [dict(zip(BATCH_COLUMNS, v)) for v in vals],
                                 codec="deflate")
    else:
        buf = bytearray()
        for v in vals:
            thrift.write_struct(buf, dict(enumerate(v, start=1)))
        with open(path, "wb") as f:
            f.write(buf)
    return path, os.path.getsize(path), time.perf_counter() - t0


def submit_batch_inputs(args, tmp, pool) -> list:
    """Phase batch_ingest's input files, one a format, written by `pool`."""
    os.makedirs(f"{tmp}/batch_in", exist_ok=True)
    return [pool.submit(write_batch_input, (
        k, fmt, args.seed + 20, BATCH_ROWS,
        f"{tmp}/batch_in/lineorder_{k}.{fmt}"))
        for k, fmt in enumerate(BATCH_FORMATS)]


class MemS3Client:
    """An in-memory object store with the boto3 client surface that
    S3PinotFS uses: the smoke's s3:// deep store (no network)."""

    def __init__(self):
        self.objects = {}

    def put_object(self, Bucket, Key, Body=b""):
        self.objects[(Bucket, Key)] = bytes(Body)

    def get_object(self, Bucket, Key):
        import io

        return {"Body": io.BytesIO(self.objects[(Bucket, Key)])}

    def head_object(self, Bucket, Key):
        if (Bucket, Key) not in self.objects:
            raise KeyError(Key)
        return {"ContentLength": len(self.objects[(Bucket, Key)])}

    def delete_object(self, Bucket, Key):
        self.objects.pop((Bucket, Key), None)

    def list_objects_v2(self, Bucket, Prefix, ContinuationToken=None):
        keys = sorted(k for b, k in self.objects
                      if b == Bucket and k.startswith(Prefix))
        return {"Contents": [{"Key": k} for k in keys], "IsTruncated": False}

    def copy_object(self, Bucket, Key, CopySource):
        self.objects[(Bucket, Key)] = \
            self.objects[(CopySource["Bucket"], CopySource["Key"])]


class MemKafka:
    """An in-process Kafka cluster: topics of partitions of records
    (offset, key, value, timestamp), and consumers with the kafka-python
    surface that KafkaStreamConsumerFactory uses (assign, seek, poll,
    partitions_for_topic, beginning_offsets, end_offsets, close): the
    smoke's `streamType: kafka` cell (no network). `publish` routes row
    dicts by a key column as the in-memory topic registry does, and
    `topic` gives the partitions back for the oracle."""

    MAX_POLL_RECORDS = 500

    def __init__(self):
        from collections import namedtuple

        self.Record = namedtuple("Record",
                                 ["offset", "key", "value", "timestamp"])
        self.lock = threading.Lock()
        self.topics = {}

    def create_topic(self, name: str, num_partitions: int = 1) -> None:
        with self.lock:
            self.topics.setdefault(name, SimpleNamespace(
                lock=self.lock,
                partitions=[[] for _ in range(num_partitions)]))

    def delete_topic(self, name: str) -> None:
        with self.lock:
            self.topics.pop(name, None)

    def topic(self, name: str):
        return self.topics[name]

    def produce(self, topic: str, partition: int, value, key=None) -> int:
        with self.lock:
            log = self.topics[topic].partitions[partition]
            log.append(self.Record(len(log), key, value,
                                   int(time.time() * 1000)))
            return len(log) - 1

    def publish(self, topic: str, rows, partition_key=None) -> None:
        n = len(self.topics[topic].partitions)
        for row in rows:
            key = row.get(partition_key) if partition_key else None
            p = hash(str(key)) % n if partition_key and n > 1 else 0
            self.produce(topic, p, row, key)

    def consumer(self) -> "MemKafkaConsumer":
        return MemKafkaConsumer(self)


class MemKafkaConsumer:
    """The subset of kafka-python's KafkaConsumer that the port's Kafka
    plugin calls, over a MemKafka."""

    def __init__(self, kafka: MemKafka):
        self.kafka = kafka
        self._assigned = []
        self._positions = {}
        self.closed = False

    def assign(self, tps) -> None:
        self._assigned = list(tps)

    def seek(self, tp, offset: int) -> None:
        self._positions[tp] = offset

    def poll(self, timeout_ms: int = 0) -> dict:
        out = {}
        with self.kafka.lock:
            for tp in self._assigned:
                log = self.kafka.topics[tp.topic].partitions[tp.partition]
                pos = self._positions.get(tp, 0)
                records = log[pos:pos + self.kafka.MAX_POLL_RECORDS]
                if records:
                    out[tp] = records
                    self._positions[tp] = records[-1].offset + 1
        return out

    def partitions_for_topic(self, topic: str):
        t = self.kafka.topics.get(topic)
        return set(range(len(t.partitions))) if t else None

    def beginning_offsets(self, tps) -> dict:
        return {tp: 0 for tp in tps}

    def end_offsets(self, tps) -> dict:
        with self.kafka.lock:
            return {tp: len(self.kafka.topics[tp.topic].partitions[
                tp.partition]) for tp in tps}

    def close(self) -> None:
        self.closed = True


def _segment_of(uri: str) -> str:
    name = os.path.basename(str(uri))
    return name[:-len(".tar.gz")] if name.endswith(".tar.gz") else name


def ms_by_segment(calls, i: int) -> dict:
    """{segment: ms} of recording(..., timed=True)'s calls, summed over the
    calls whose argument i names one segment."""
    out = {}
    for args, ms in calls:
        seg = _segment_of(args[i])
        out[seg] = out.get(seg, 0.0) + ms
    return out


def minion_tasks(store, ctl, broker, server, table, work_dir, want, run,
                 broker_rows) -> tuple:
    """The minion on the card over the sink's 2 segments on `server`: a
    MergeRollupTask (concat) swaps in one merged segment through lineage,
    the server loads it, and q2_family over it makes one launch of kernel
    B with the oracle's rows (the pre-merge answer); then a PurgeTask
    evaluates SINK_PURGE on the merged segment's planes on the card and
    swaps in the rest, and q2_family gives the oracle's rows without the
    purged ones; each q2_family over the lone segment makes one launch, of
    kernel B where the fused plan takes the segment's planes, else of
    kernel A. (report, {label: (kernel, its inputs, the segment's rows)})."""
    from pinot_tpu_torch.minion import MinionInstance, PinotTaskManager
    from pinot_tpu_torch.minion import tasks as mtasks

    cache = server.executor.executor.cache
    manager = PinotTaskManager(store, ctl)
    minion = MinionInstance(store, "Minion_0", ctl, work_dir, device=DEVICE)
    out, recs = {}, {}
    for task, label, want_key in (
            ("MergeRollupTask", "merged_q2_family", "sink_q2_family"),
            ("PurgeTask", "purged_q2_family", "purged_q2_family")):
        before = set(store.children(f"/SEGMENTS/{table}"))
        resident = cache.bytes_used()
        ids = manager.schedule_tasks(table=table, task_type=task)
        with recording(mtasks, "_build_and_add", timed=True) as builds, \
                recording(mtasks, "_replace_via_lineage", timed=True) as swaps, \
                recording(mtasks, "purge_mask", timed=True) as masks:
            t0 = time.perf_counter()
            ran = minion.run_pending_once()
            task_ms = (time.perf_counter() - t0) * 1e3
        state = store.get(f"/TASKS/{task}/{ids[0]}") if ids else None
        if ran != 1 or state["state"] != "COMPLETED":
            raise AssertionError(f"minion {task}: ran {ran}, {state}")
        after = store.children(f"/SEGMENTS/{table}")
        if len(after) != 1 or set(after) & before:
            raise AssertionError(f"minion {task}: segments {before} -> "
                                 f"{after}")
        _wait_for(lambda: not (before & cache.segment_names()), BATCH_WAIT_S,
                  f"minion {task}: the replaced segments' planes released")
        freed = resident - cache.bytes_used()
        _wait_for(lambda: set(broker.routing_table(table)) == set(after),
                  BATCH_WAIT_S, f"minion {task}: {after} routed")
        ms, a_calls, b_calls = run(label, BATCH_QUERIES["sink_q2_family"],
                                   want[want_key], None, broker_rows)
        if len(a_calls) + len(b_calls) != 1:
            raise AssertionError(f"minion {label}: {len(a_calls)} + "
                                 f"{len(b_calls)} launches of A + B")
        rows = SINK_ROWS - (want["purged_rows"] if task == "PurgeTask"
                            else 0)
        recs[label] = (("limb_sums", a_calls, rows) if a_calls
                       else ("fused_limb_sums", b_calls, rows))
        build_ms = sum(t for _, t in builds)
        rec = {"task_ms": task_ms, "build_ms": build_ms,
               "swap_ms": sum(t for _, t in swaps) - build_ms,
               "card_bytes_freed": freed, "segments": after,
               "output": state["output"], "q2_family_cold_ms": ms}
        if masks:
            rec["mask_ms"] = sum(t for _, t in masks)
            if state["output"]["purged"] != {
                    next(iter(before)): want["purged_rows"]}:
                raise AssertionError(f"minion purge: {state['output']}, "
                                     f"{want['purged_rows']} rows expected")
        elif state["output"]["numDocs"] != SINK_ROWS:
            raise AssertionError(f"minion merge: {state['output']}")
        if freed <= 0:
            raise AssertionError(f"minion {task}: {freed} card bytes freed")
        out[task] = rec
    return out, recs


def phase_batch_ingest(args, torch, tmp, inputs, _cuda, mxu, fg, card) -> dict:
    """The offline data path (ingestion/batch.py, plugins/inputformat/,
    spi/filesystem.py, plugins/filesystem/s3.py, connectors/, client.py)
    on the card: the multiprocess job over the 4 input files `inputs`
    wrote, the tar push to 2 card servers (one tarball through an s3://
    deep store), the queries on the card with the oracle's rows and every
    kernel launch counted from 0 and recorded, the sink into a second
    table served by one server, the HTTP client, and the Arrow reads where
    pyarrow is importable."""
    import dataclasses

    from pinot_tpu_torch import client as pclient
    from pinot_tpu_torch.cluster import (Broker, ClusterController,
                                         PropertyStore, ServerInstance)
    from pinot_tpu_torch.cluster import server as server_mod
    from pinot_tpu_torch.cluster.rest import BrokerRestServer
    from pinot_tpu_torch.connectors import StreamingSegmentWriter
    from pinot_tpu_torch.ingestion import batch
    from pinot_tpu_torch.plugins.filesystem.s3 import S3PinotFS
    from pinot_tpu_torch.spi import filesystem

    t_phase = time.perf_counter()
    total = BATCH_ROWS * len(BATCH_FORMATS)
    cols = gen_ssb(total, args.seed + 20)
    want = {"q2": q2_oracle(cols), "count": [[total]]}
    want["q2_family"] = want["q2"]
    scanned = (cols["d_year"] == 1993) & (cols["lo_discount"] == 1)
    want["scan"] = (int(scanned.sum()),
                    int(cols["lo_revenue"][scanned].astype(np.int64).sum()))
    del cols, scanned
    files = {}
    for fut in inputs:
        path, nbytes, sec = fut.result()
        files[os.path.basename(path)] = {"bytes": nbytes, "write_s": sec}
    out = {"card": card, "rows": total, "files": files}
    recs, launches = {}, {}
    schema, cfg = _data_table(BATCH_TABLE)

    # -- the job: one segment a file, in 4 spawned workers -------------------
    spec = batch.SegmentGenerationJobSpec(
        input_dir_uri=f"file://{tmp}/batch_in",
        output_dir_uri=f"file://{tmp}/batch_deep", schema=schema,
        table_config=cfg, include_file_name_pattern="lineorder_*",
        record_reader_config={"fieldIdToName": BATCH_THRIFT_IDS},
        segment_name_prefix=BATCH_TABLE, create_tar=True,
        execution_framework="multiprocess", parallelism=BATCH_WORKERS)
    t0 = time.perf_counter()
    results = batch.IngestionJobLauncher(spec).run()
    job_s = time.perf_counter() - t0
    if [r.num_docs for r in results] != [BATCH_ROWS] * len(BATCH_FORMATS) \
            or any(r.rows_filtered for r in results):
        raise AssertionError(f"batch_ingest job: {results}")
    out["job"] = {"seconds": job_s, "rows_per_s": total / job_s,
                  "workers": BATCH_WORKERS, "per_format": {
                      fmt: {"us_per_row": {k: v * 1e3 / r.num_docs
                                           for k, v in r.timings_ms.items()},
                            "file_s": sum(r.timings_ms.values()) / 1e3,
                            "tar_bytes": os.path.getsize(
                                r.output_uri[len("file://"):])}
                      for fmt, r in zip(BATCH_FORMATS, results)}}

    # -- the push: 2 card servers, one tarball through s3:// ----------------
    mem = MemS3Client()
    saved_s3 = filesystem._FS_REGISTRY.get("s3")
    filesystem.register_fs("s3", lambda: S3PinotFS(client=mem))
    store = PropertyStore()
    ctl = ClusterController(store)
    servers = [ServerInstance(store, f"Server_{i}", device=DEVICE,
                              tags=["DefaultTenant"] + ([SINK_TAG] if i == 0
                                                        else []))
               for i in range(CLUSTER_SERVERS)]
    broker = Broker(store)
    rest = None
    fs_classes = (filesystem.LocalPinotFS, S3PinotFS)

    def caches():
        return [s.executor.executor.cache for s in servers]

    def await_online(table, n):
        return _wait_for(lambda: len(broker.routing_table(table)) == n,
                         BATCH_WAIT_S, f"batch_ingest: {n} segments of "
                         f"{table} ONLINE")

    def run(label, sql, qwant, per_kernel, query=None):
        """One query with every count set to 0 just before it: its rows the
        oracle's, its launches `per_kernel` exactly; its kernel inputs."""
        _cuda.reset_launches()
        with recording(mxu, "limb_sums") as a_calls, \
                recording(fg, "fused_limb_sums") as b_calls:
            t0 = time.perf_counter()
            rows = (query or (lambda q: broker.execute_sql(q)))(sql)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        made = dict(_cuda.LAUNCHES)
        if sorted(map(tuple, rows)) != sorted(map(tuple, qwant)):
            raise AssertionError(f"batch_ingest {label}: {len(rows)} rows "
                                 f"against the oracle's {len(qwant)}")
        if per_kernel is not None and made != per_kernel:
            raise AssertionError(f"batch_ingest {label}: launches {made}, "
                                 f"{per_kernel} expected")
        launches[label] = made
        return ms, list(a_calls), list(b_calls)

    def broker_rows(sql):
        resp = broker.execute_sql(sql)
        if resp.exceptions:
            raise AssertionError(f"batch_ingest: {resp.exceptions}")
        return resp.result_table.rows

    try:
        for srv in servers:
            srv.start()
        ctl.add_schema(schema.to_json())
        table = ctl.create_table({"tableName": BATCH_TABLE,
                                  "replication": 1})
        last = results[-1]
        s3_uri = f"s3://deep/{BATCH_TABLE}/{last.segment_name}.tar.gz"
        with recording(batch, "untar_segment", timed=True) as untars, \
                recording(fs_classes[0], "open", timed=True) as local_opens, \
                recording(fs_classes[1], "open", timed=True) as s3_opens, \
                recording(server_mod, "load_segment", timed=True) as loads:
            t0 = time.perf_counter()
            filesystem.get_fs(s3_uri).copy_from_local(
                last.output_uri[len("file://"):], s3_uri)
            s3_put_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            batch.push_segments_to_cluster(
                results[:-1] + [dataclasses.replace(last, output_uri=s3_uri)],
                ctl, table)
            push_ms = (time.perf_counter() - t0) * 1e3
            online_s = await_online(table, len(results))
        ideal = store.get(f"/IDEALSTATES/{table}")
        # the fetch is the file system's open: the in-memory s3:// store's
        # whole object, a file:// handle; the untar streams from it
        untar_ms, load_ms = ms_by_segment(untars, 0), ms_by_segment(loads, 0)
        s3_fetch = ms_by_segment(s3_opens, 1)
        fetch_ms = dict(ms_by_segment(local_opens, 1), **s3_fetch)
        per_server = {}
        for seg, insts in sorted(ideal.items()):
            for inst in insts:
                per_server.setdefault(inst, {})[seg] = {
                    "fetch_ms": fetch_ms[seg],
                    "untar_ms": untar_ms[seg] - fetch_ms[seg],
                    "load_ms": load_ms[seg],
                    "deep_store": "s3" if seg == last.segment_name
                    else "file"}
        if not s3_fetch or set(s3_fetch) != {last.segment_name} or \
                sorted(len(v) for v in per_server.values()) != [2, 2]:
            raise AssertionError(f"batch_ingest push: {per_server}, s3 "
                                 f"fetches {s3_fetch}")
        out["push"] = {"s3_put_ms": s3_put_ms, "push_ms": push_ms,
                       "online_s": online_s, "servers": per_server}

        # -- the queries on the card ----------------------------------------
        family = {"limb_sums": CLUSTER_SERVERS, "fused_limb_sums": 0}
        cold_ms, recs["q2_family"], _ = run(
            "q2_family", BATCH_QUERIES["q2_family"], want["q2_family"],
            family, broker_rows)
        warm = []
        for _ in range(BATCH_ITERS):
            t0 = time.perf_counter()
            broker_rows(BATCH_QUERIES["q2_family"])
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0) * 1e3)
        q2_ms, _, recs["q2"] = run(
            "q2", BATCH_QUERIES["q2"], want["q2"],
            {"limb_sums": 0, "fused_limb_sums": len(results)}, broker_rows)
        count_ms, _, _ = run("count", BATCH_QUERIES["count"], want["count"],
                             None, broker_rows)
        out["queries"] = {
            "q2_family_cold_ms": cold_ms,
            "q2_family_warm_p50_ms": float(np.median(warm)),
            "q2_family_warm_ms": warm, "q2_ms": q2_ms, "count_ms": count_ms,
            "count": total, "launches": dict(launches),
            "resident_bytes": sum(c.bytes_used() for c in caches())}

        # -- the sink: a second table on Server_0 ---------------------------
        sink_schema, sink_cfg = _data_table(SINK_TABLE)
        ctl.add_schema(sink_schema.to_json())
        sink_table = ctl.create_table({
            "tableName": SINK_TABLE, "replication": 1, "serverTag": SINK_TAG,
            "taskConfigs": {"MergeRollupTask": {"mergeType": "concat"},
                            "PurgeTask": {"purgeFilter": SINK_PURGE}}})
        scols = gen_ssb(SINK_ROWS, args.seed + 21)
        want["sink_q2_family"] = q2_oracle(scols)
        purged = (scols["lo_quantity"] == 7) & (scols["lo_discount"] < 6)
        want["purged_rows"] = int(purged.sum())
        want["purged_q2_family"] = q2_oracle(
            {k: v[~purged] for k, v in scols.items()})
        rows = [dict(zip(BATCH_COLUMNS, v)) for v in zip(
            *(scols[c].tolist() for c in BATCH_COLUMNS))]
        del scols, purged
        t0 = time.perf_counter()
        writer = StreamingSegmentWriter(
            sink_schema, f"{tmp}/sink_deep", sink_cfg, controller=ctl,
            table_name_with_type=sink_table, flush_max_rows=SINK_FLUSH_ROWS)
        for row in rows:
            writer.collect(row)
        uris = writer.close()
        sink_s = time.perf_counter() - t0
        del rows
        if len(uris) != SINK_ROWS // SINK_FLUSH_ROWS:
            raise AssertionError(f"batch_ingest sink: {uris}")
        sink_online_s = await_online(sink_table, len(uris))
        sink_ms, recs["sink_q2_family"], _ = run(
            "sink_q2_family", BATCH_QUERIES["sink_q2_family"],
            want["sink_q2_family"], {"limb_sums": 1, "fused_limb_sums": 0},
            broker_rows)
        out["sink"] = {"rows": SINK_ROWS, "segments": len(uris),
                       "flush_rows": SINK_FLUSH_ROWS, "seconds": sink_s,
                       "us_per_row": sink_s * 1e6 / SINK_ROWS,
                       "online_s": sink_online_s, "q2_family_ms": sink_ms}

        # -- the minion: merge the sink's 2 segments, then purge ~1% --------
        out["minion"], recs_m = minion_tasks(
            store, ctl, broker, servers[0], sink_table, f"{tmp}/minion", want,
            run, broker_rows)
        recs.update(recs_m)

        # -- the HTTP client against a BrokerRestServer ---------------------
        rest = BrokerRestServer(broker)
        conn = pclient.connect(rest.url)
        client_ms, recs["client_q2_family"], _ = run(
            "client_q2_family", BATCH_QUERIES["q2_family"],
            want["q2_family"], family, lambda q: conn.execute(q).rows)
        out["client"] = {"q2_family_ms": client_ms}

        # -- the Arrow reads (pyarrow is an optional library) ---------------
        try:
            import pyarrow  # noqa: F401
        except ImportError:
            out["arrow"] = "pyarrow not installed"
        else:
            from pinot_tpu_torch.connectors import read_sql, read_table
            from pinot_tpu_torch.connectors.dataframe import scan_table

            t0 = time.perf_counter()
            t = read_table(broker, table, columns=["lo_revenue"])
            if t.num_rows != total:
                raise AssertionError(f"batch_ingest read_table: "
                                     f"{t.num_rows} rows")
            read_table_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            batches = [b for _, b in scan_table(
                broker, table, ["lo_revenue"],
                where="d_year = 1993 AND lo_discount = 1")]
            scan = (sum(b.num_rows for b in batches),
                    sum(sum(b.column(0).to_pylist()) for b in batches))
            if len(batches) != len(results) or scan != want["scan"]:
                raise AssertionError(f"batch_ingest scan_table: {scan} "
                                     f"against {want['scan']}")
            scan_table_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = read_sql(BATCH_QUERIES["q2_family"], connection=conn)
            if sorted(map(tuple, zip(*got.to_pydict().values()))) != \
                    sorted(map(tuple, want["q2_family"])):
                raise AssertionError("batch_ingest read_sql: rows differ")
            out["arrow"] = {"read_table_s": read_table_s,
                            "scan_table_s": scan_table_s,
                            "scan_table_rows": scan[0],
                            "read_sql_s": time.perf_counter() - t0}
    finally:
        if rest is not None:
            rest.close()
        for srv in servers:
            if srv._started:
                srv.stop()
        broker.close()
        if saved_s3 is None:
            filesystem._FS_REGISTRY.pop("s3", None)
        else:
            filesystem.register_fs("s3", saved_s3)
    del servers, broker
    gc.collect()
    torch.cuda.empty_cache()

    parity = {}
    for label in ("q2_family", "sink_q2_family", "client_q2_family"):
        parity[label] = max(check_equal(
            torch, f"limb_sums batch_ingest {label}, launch {k}",
            mxu.limb_sums(*rec), mxu.limb_sums_plain(*rec))
            for k, rec in enumerate(recs[label]))
    parity["q2"] = max(check_equal(
        torch, f"fused_limb_sums batch_ingest q2, launch {k}",
        fg.fused_limb_sums(*rec), fg.fused_limb_sums_plain(*rec))
        for k, rec in enumerate(recs["q2"]))
    for label in ("merged_q2_family", "purged_q2_family"):
        name, rs, _ = recs[label]
        owner = mxu if name == "limb_sums" else fg
        parity[label] = check_equal(
            torch, f"{name} batch_ingest {label}",
            getattr(owner, name)(*rs[0]),
            getattr(owner, name + "_plain")(*rs[0]))
    out["parity"] = parity
    emit(dict({"phase": "batch_ingest",
               "seconds": time.perf_counter() - t_phase,
               "note": "one process: the servers, the broker and the REST "
                       "server share its GIL and its card; the job's "
                       "workers are processes of their own; host clock"},
              **out))
    return {"recs": recs, "parity": parity, "launches": launches}


# phase `soak`: the soak harness's device-reaching suites
# (pinot_tpu_torch/tools/soak.py) through their entry points. sql: the
# fuzz table at 2^16 rows (the harness's default is 1,600), checks enough
# for about 20 s; qps: 3 servers, replication 2, 6 segments of 2^21 rows,
# the 5 query families at 50 queries/s from 8 workers for 20 s under
# backend "device", then a shorter run under corrupt_rate 0.02 over 6
# segments of 2^19 rows (the wire corruptions do not depend on the data's
# size); realtime: one committer-crash round, then 10 s of device churn
SOAK_SEED = 2033
SOAK_SQL_ROWS = 1 << 16
SOAK_SQL_CHECKS = 60
SOAK_QPS = {"seconds": 20.0, "qps": 50.0, "concurrency": 8, "n_servers": 3,
            "replication": 2, "n_segments": 6, "rows_per_segment": 1 << 21,
            "families": 5}
SOAK_CORRUPT = dict(SOAK_QPS, seconds=6.0, rows_per_segment=1 << 19,
                    corrupt_rate=0.02)
SOAK_RT_SECONDS = 10.0
SOAK_KEEP = 2  # inputs kept for each kernel and shape of a soak suite
# the most launched shapes of each kernel a suite times in the kernel table
SOAK_ROWS_TIMED = {"sql": 1, "qps": 3}


def _soak_shape(name: str, args) -> tuple:
    """The shape of a kernel call: kernel A's (planes, gid, G) or kernel
    B's (fp, planes_in, scalars, G, n)."""
    if name == "limb_sums":
        return tuple(args[0].shape), int(args[2])
    fp, planes_in, _, G, n = args
    return n, int(G), len(fp.planes), tuple(str(t.dtype) for t in planes_in)


@contextlib.contextmanager
def sampled_recording(owner, name):
    """Count every call to owner.name by shape (calls go through, from any
    thread) and keep the positional arguments of the first SOAK_KEEP calls
    of each shape: a soak suite makes thousands of calls, at the card's
    data size too many to keep every input."""
    kept, counts, lock = {}, {}, threading.Lock()
    orig = getattr(owner, name)

    def wrapper(*args, **kwargs):
        key = _soak_shape(name, args)
        with lock:
            counts[key] = counts.get(key, 0) + 1
            if len(kept.setdefault(key, [])) < SOAK_KEEP:
                kept[key].append(args)
        return orig(*args, **kwargs)

    setattr(owner, name, wrapper)
    try:
        yield kept, counts
    finally:
        setattr(owner, name, orig)


@contextlib.contextmanager
def double_strikes():
    """Count the wire corruptions (transport.call) that strike a response
    whose DataTable a datatable.encode corruption already damaged: one
    response, two strikes, one detection at the broker."""
    from pinot_tpu_torch.cluster import datatable, transport

    hits, orig = [0], transport._corrupt_payload

    def wrapper(payload, c):
        if isinstance(payload, dict) and "datatable" in payload:
            try:
                datatable.decode(payload["datatable"])
            except datatable.DataTableError:
                hits[0] += 1
        return orig(payload, c)

    transport._corrupt_payload = wrapper
    try:
        yield hits
    finally:
        transport._corrupt_payload = orig


def phase_soak(torch, _cuda, mxu, fg, card) -> dict:
    """The soak harness (tools/soak.py) on the card, through its entry
    points with device "cuda": soak_sql with device parity (the host
    engine against sqlite, backend "auto" against the host engine),
    soak_qps under backend "device" over an embedded cluster of card
    servers, a shorter soak_qps under a corrupt schedule (every corrupted
    response the broker receives must be detected: strikes less
    double_strikes), and soak_realtime's committer-crash
    round and device churn. Each suite raises on a wrong full answer.
    Launches are counted from 0 just before each suite and read just
    after; the sql and qps suites' kernel calls are counted by shape and
    the first SOAK_KEEP inputs of each shape held against the plain
    versions. Per suite: its summary, checks or queries a second, p50 /
    p99, device dispatches, launches and seconds."""
    from pinot_tpu_torch.engine.query_executor import QueryExecutor
    from pinot_tpu_torch.tools import soak

    t_phase = time.perf_counter()
    out, recs, parity = {}, {}, {}

    def run(label, fn, **kw):
        t0 = time.perf_counter()
        _cuda.reset_launches()
        with sampled_recording(mxu, "limb_sums") as (a_kept, a_n), \
                sampled_recording(fg, "fused_limb_sums") as (b_kept, b_n):
            res = fn(device=DEVICE, **kw)
            torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
        made = {"limb_sums": sum(a_n.values()),
                "fused_limb_sums": sum(b_n.values())}
        if made != launches:
            raise AssertionError(f"soak {label}: {made} wrapper calls, "
                                 f"{launches} launches")
        for name, owner, kept in (("limb_sums", mxu, a_kept),
                                  ("fused_limb_sums", fg, b_kept)):
            for key, rs in kept.items():
                for k, rec in enumerate(rs):
                    parity[f"{name}/soak_{label}_{key}/launch{k}"] = \
                        check_equal(torch, f"{name} soak {label} {key} "
                                    f"launch {k}",
                                    getattr(owner, name)(*rec),
                                    getattr(owner, name + "_plain")(*rec))
        recs[label] = {"limb_sums": (a_kept, a_n),
                       "fused_limb_sums": (b_kept, b_n)}
        res = dict(res, launches=launches,
                   launches_by_shape={name: {str(k): v for k, v in n.items()}
                                      for name, n in (("limb_sums", a_n),
                                                      ("fused_limb_sums",
                                                       b_n))},
                   seconds=time.perf_counter() - t0)
        out[label] = res
        return res

    sql = run("sql", soak.soak_sql, seconds=600.0, seed=SOAK_SEED,
              rows=SOAK_SQL_ROWS, device_parity=True,
              max_checks=SOAK_SQL_CHECKS)
    sql["achieved_qps"] = sql["checks"] / sql["elapsed_s"]
    if sql["checks"] < SOAK_SQL_CHECKS or not sql["device_dispatches"]:
        raise AssertionError(f"soak sql: {sql}")
    qps = run("qps", soak.soak_qps, seed=SOAK_SEED, backend="device",
              **SOAK_QPS)
    if not qps["queries_ok"] or qps["queries_degraded"] or \
            not qps["device_dispatches"] or not qps["launches"]["limb_sums"]:
        raise AssertionError(f"soak qps: {qps}")
    with double_strikes() as doubled:
        corrupt = run("qps_corrupt", soak.soak_qps, seed=SOAK_SEED + 1,
                      backend="device", **SOAK_CORRUPT)
    cor = corrupt["corruptions"]
    cor["double_strikes"] = doubled[0]
    # every corrupted response the broker received was detected
    if not cor["injected"] or \
            cor["detected"] != cor["injected"] - doubled[0] or \
            not corrupt["queries_ok"]:
        raise AssertionError(f"soak qps_corrupt: {corrupt}")
    # the realtime churn's device queries, timed on the host clock
    with recording(QueryExecutor, "execute_sql", timed=True) as calls:
        rt = run("realtime", soak.soak_realtime, rounds=1, seed=SOAK_SEED,
                 seconds=SOAK_RT_SECONDS)
    lat = [ms for (qe, _), ms in calls if qe.backend == "auto"]
    rt.update(device_queries=len(lat),
              achieved_qps=len(lat) / SOAK_RT_SECONDS,
              device_p50_ms=float(np.percentile(lat, 50)),
              device_p99_ms=float(np.percentile(lat, 99)))
    if rt["rounds"] != 1 or not rt["device_dispatches"] or \
            not rt["device_settles"]:
        raise AssertionError(f"soak realtime: {rt}")
    suites_s = time.perf_counter() - t_phase
    # timed right after the phase, as phase host_engine's rows are
    rows = soak_rows(torch, _cuda, mxu, fg, recs, parity)
    del recs
    torch.cuda.empty_cache()
    emit(dict({"phase": "soak", "card": card,
               "seconds": time.perf_counter() - t_phase,
               "suites_s": suites_s,
               "kernel_rows_s": time.perf_counter() - t_phase - suites_s,
               "note": "one process: the soak's servers, broker, workers and "
                       "oracles share its GIL; host clock; every full answer "
                       "exact (the suites raise otherwise)"}, **out))
    return {"rows": rows, "parity": parity}


def soak_rows(torch, _cuda, mxu, fg, recs, parity) -> list:
    """The kernel table's rows of phase `soak`: each suite's
    SOAK_ROWS_TIMED most launched shapes of each kernel; each row's
    launches are its shape's in the suite."""
    rows = []
    for label, top in SOAK_ROWS_TIMED.items():
        for name, (kept, counts) in recs[label].items():
            total = sum(counts.values())
            for key in sorted(counts, key=lambda k: -counts[k])[:top]:
                err = max(v for k, v in parity.items()
                          if k.startswith(f"{name}/soak_{label}_{key}/"))
                note = (f"soak {label}: {counts[key]} of the suite's {total} "
                        f"launches of {name} ({len(counts)} shapes)")
                if name == "limb_sums":
                    rows.append(kernel_a_row(torch, mxu, _cuda, kept[key],
                                             counts[key], err, note))
                else:
                    rows.append(kernel_b_row(torch, fg, _cuda, kept[key],
                                             counts[key], err, note))
    return rows


QUICKSTART_ROWS = 100_000  # tools/admin.py quickstart's default
HOST_THREADS = 4  # the host engine's worker threads (num_threads)


def quickstart_oracle(rows: int) -> list:
    """tools/admin.py quickstart's three demo answers by numpy over its
    columns."""
    from pinot_tpu_torch.tools.admin import quickstart_segments

    segs = quickstart_segments(rows)
    c = {k: np.concatenate([s[k] for s in segs]) for k in segs[0]}
    runs = {t: float(c["runs"][c["teamID"] == t].sum())
            for t in sorted(set(c["teamID"].tolist()))}
    years = sorted({int(y) for y in c["yearID"].tolist() if y >= 2015})
    return [[[len(c["runs"])]],
            [[t, v] for t, v in sorted(runs.items(), key=lambda kv: -kv[1])
             ][:5],
            [[y, float(c["homeRuns"][c["yearID"] == y].max())]
             for y in years][:10]]


def phase_host_engine(args, torch, qe, tables, expected, _cuda, mxu, fg, tmp,
                      card) -> dict:
    """The host engine (engine/host_executor.py, engine/funnel.py, the
    index readers) and QueryExecutor's backends on the card's host: under
    backend "host", q1 and q2_family over `ssb` and the clicks queries, no
    dispatch and no launch, each timed once; under "auto", the clicks
    queries (the device-planned ones one family dispatch and one launch of
    kernel A each, the funnels and the geo filter on the host) and
    RT_AUTO_SQL over `ssb_rt` (the committed family one launch of kernel
    A, the refused consuming snapshot on the host engine); every row
    against its numpy oracle, every launch against its plain version.
    Then a PurgeTask over a raw STRING filter (the planner refuses it, the
    host engine evaluates it) on a card server and minion, the purged
    segment's rows against the oracle's; then `python -m
    pinot_tpu_torch.tools.admin quickstart --once` in a child process, its
    servers on the card, its demo rows against the oracle."""
    from pinot_tpu_torch.cluster import (ClusterController, PropertyStore,
                                         ServerInstance)
    from pinot_tpu_torch.engine.host_executor import HostSegmentExecutor
    from pinot_tpu_torch.engine.query_executor import QueryExecutor
    from pinot_tpu_torch.minion import MinionInstance, PinotTaskManager
    from pinot_tpu_torch.minion import tasks as mtasks
    from pinot_tpu_torch.segment.builder import SegmentBuilder
    from pinot_tpu_torch.segment.loader import load_segment
    from pinot_tpu_torch.spi.data_types import Schema
    from pinot_tpu_torch.spi.table_config import IndexingConfig, TableConfig

    t_phase = time.perf_counter()
    # the admin CLI's quickstart in a child process, its servers on the
    # card, while this process runs the host engine's queries
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get(
        "PYTHONPATH", ""), TMPDIR=tmp)
    child = subprocess.Popen(
        [sys.executable, "-m", "pinot_tpu_torch.tools.admin", "quickstart",
         "--once", "--rows", str(QUICKSTART_ROWS), "--device", DEVICE],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    host = QueryExecutor(device=DEVICE, backend="host",
                         num_threads=HOST_THREADS)
    auto = QueryExecutor(device=DEVICE, backend="auto",
                         num_threads=HOST_THREADS)
    for name in ("ssb", CLICKS_TABLE):
        host.add_table(*tables[name])
    auto.add_table(*tables[CLICKS_TABLE])
    rt = qe.tables[RT_TABLE]
    auto.add_table(rt.schema, rt.segments, RT_TABLE)
    out, recs, launches, parity = {"host": {}, "auto": {}}, {}, {}, {}

    def run(backend, engine, qname, sql, want, ordered=True):
        _cuda.reset_launches()
        with recording(mxu, "limb_sums") as a_calls, \
                recording(fg, "fused_limb_sums") as b_calls:
            t0 = time.perf_counter()
            resp = engine.execute_sql(sql)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        made = dict(_cuda.LAUNCHES)
        _rows_equal(f"host_engine {backend} {qname}", resp, want, ordered)
        out[backend][qname] = {
            "ms": ms, "dispatches": resp.num_device_dispatches,
            "docs_scanned": resp.num_docs_scanned, "launches": made}
        return resp, made, list(a_calls), list(b_calls)

    def on_the_device(backend, qname, resp, made, a_calls, b_calls):
        """One family dispatch and one launch of kernel A, held against its
        plain version."""
        if resp.num_device_dispatches != 1 or made != {
                "limb_sums": 1, "fused_limb_sums": 0} or b_calls:
            raise AssertionError(f"host_engine {backend} {qname}: "
                                 f"{resp.num_device_dispatches} dispatches, "
                                 f"launches {made}")
        recs[qname], launches[qname] = a_calls, made
        parity[qname] = check_equal(
            torch, f"limb_sums host_engine {qname}",
            mxu.limb_sums(*a_calls[0]), mxu.limb_sums_plain(*a_calls[0]))
        out[backend][qname]["family"] = list(a_calls[0][0].shape)
        out[backend][qname]["kernel_G"] = int(a_calls[0][2])

    try:
        for qname in HOST_SSB_QUERIES:
            run("host", host, qname, QUERIES[qname], expected[qname],
                qname in ORDERED)
        for qname, sql in CLICKS_QUERIES.items():
            run("host", host, qname, sql, expected[qname])
        for qname, rec in out["host"].items():
            if rec["dispatches"] or any(rec["launches"].values()):
                raise AssertionError(f"host_engine host {qname}: {rec}")
        for qname, sql in CLICKS_QUERIES.items():
            got = run("auto", auto, qname, sql, expected[qname])
            if qname in CLICKS_DEVICE:
                on_the_device("auto", qname, *got)
            elif got[0].num_device_dispatches or any(got[1].values()):
                raise AssertionError(f"host_engine auto {qname}: "
                                     f"{out['auto'][qname]}")
        on_the_device("auto", "rt_auto", *run(
            "auto", auto, "rt_auto", RT_AUTO_SQL, expected["rt_q2"], False))
    finally:
        del host, auto
        torch.cuda.empty_cache()

    # -- a PurgeTask over a raw STRING filter --------------------------------
    t0 = time.perf_counter()
    schema = Schema.build(PURGE_TABLE, dimensions=CLICKS_DIMS,
                          metrics=CLICKS_METRICS)
    cols, page, _ = clicks_columns(0, PURGE_ROWS)
    seg_dir, work = f"{tmp}/{PURGE_TABLE}_0", f"{tmp}/purge_work"
    SegmentBuilder(schema, TableConfig(table_name=PURGE_TABLE, indexing=
                   IndexingConfig(no_dictionary_columns=["url"] + list(
                       CLICKS_INDEXING["no_dictionary_columns"]))),
                   f"{PURGE_TABLE}_0").build(cols, seg_dir)
    purged = np.isin(page, [k for k, u in enumerate(CLICKS_PAGES)
                            if u.startswith("/c") or u == "/help"])
    store = PropertyStore()
    ctl = ClusterController(store)
    server = ServerInstance(store, "Server_0", device=DEVICE)
    server.start()
    try:
        ctl.add_schema(schema.to_json())
        table = ctl.create_table({
            "tableName": PURGE_TABLE, "replication": 1,
            "taskConfigs": {"PurgeTask": {"purgeFilter": PURGE_FILTER}}})
        ctl.add_segment(table, f"{PURGE_TABLE}_0",
                        {"location": seg_dir, "numDocs": PURGE_ROWS})
        _wait_for(lambda: f"{PURGE_TABLE}_0" in server.segments.get(
            table, {}), BATCH_WAIT_S, "the purge table's segment loaded")
        manager = PinotTaskManager(store, ctl)
        minion = MinionInstance(store, "Minion_0", ctl, work, device=DEVICE)
        ids = manager.schedule_tasks(table=table, task_type="PurgeTask")
        _cuda.reset_launches()
        with recording(HostSegmentExecutor, "_filter_mask") as host_masks, \
                recording(mtasks, "purge_mask", timed=True) as masks:
            t1 = time.perf_counter()
            ran = minion.run_pending_once()
            task_ms = (time.perf_counter() - t1) * 1e3
        state = store.get(f"/TASKS/PurgeTask/{ids[0]}") if ids else None
        if ran != 1 or state["state"] != "COMPLETED" or len(host_masks) != 1:
            raise AssertionError(f"host_engine purge: ran {ran}, {state}, "
                                 f"{len(host_masks)} host masks")
        if state["output"]["purged"] != {f"{PURGE_TABLE}_0":
                                         int(purged.sum())}:
            raise AssertionError(f"host_engine purge: {state['output']}, "
                                 f"{int(purged.sum())} rows expected")
        after = store.children(f"/SEGMENTS/{table}")
        kept = load_segment(ctl.segment_metadata(table, after[0])["location"])
        for c, v in cols.items():
            if not np.array_equal(kept.get_values(c), v[~purged]):
                raise AssertionError(f"host_engine purge: column {c} of "
                                     f"{after} differs from the oracle's")
        if any(_cuda.LAUNCHES.values()):
            raise AssertionError(f"host_engine purge: {_cuda.LAUNCHES}")
        out["purge"] = {"rows": PURGE_ROWS, "purged": int(purged.sum()),
                        "filter": PURGE_FILTER, "task_ms": task_ms,
                        "mask_ms": sum(t for _, t in masks),
                        "seconds": time.perf_counter() - t0}
    finally:
        server.stop()

    # -- the quickstart child's demo rows ------------------------------------
    t0 = time.perf_counter()
    try:
        stdout, stderr = child.communicate(timeout=CHILD_START_S + 120)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        raise AssertionError(f"host_engine quickstart: exit "
                             f"{child.returncode}: {stderr[-2000:]}")
    demo = [json.loads(line.split("json: ", 1)[1])
            for line in stdout.splitlines() if line.startswith("  json: ")]
    if demo != quickstart_oracle(QUICKSTART_ROWS):
        raise AssertionError(f"host_engine quickstart: demo rows {demo}")
    if stdout.count(f"({DEVICE}") < 2:
        raise AssertionError("host_engine quickstart: servers not on the "
                             f"card: {stdout[:400]}")
    out["quickstart"] = {"rows": QUICKSTART_ROWS, "demo_queries": len(demo),
                         "waited_s": time.perf_counter() - t0,
                         "process_s": time.perf_counter() - t_phase}
    emit(dict({"phase": "host_engine", "card": card, "oracle": "equal",
               "seconds": time.perf_counter() - t_phase,
               "note": "host clock, one run a query ending in a "
                       "synchronize; launches counted from 0 before each"},
              **out))
    return {"recs": recs, "launches": launches, "parity": parity}


MESH_DEVICES = ["cuda:0"] * 4  # the one card, four mesh positions
MESH_ITERS = 3
NATIVE_PLANE_BITS = 13  # a 2^23-value dict-id plane of up to 8192 values


def _mbps(nbytes: int, seconds: float) -> float:
    return nbytes / 1e6 / seconds if seconds > 0 else float("inf")


def phase_mesh(args, torch, qe, tables, formats_dirs, expected, _cuda, mxu,
               fg, card) -> dict:
    """The mesh (parallel/mesh.py) and the native host library
    (segment/native_bridge.py) on the card, over tables phase `data` and
    `segment_formats` built.

    Row sharding: q2's plan over the first 2^23-row `ssb` segment split
    over 4 shards on cuda:0, through run_program_row_sharded: kernel B once
    a shard at row offsets 0, 2^21, 2^22 and 3 * 2^21, each launch held
    element-equal against fused_limb_sums_plain, the merged table equal to
    the solo fused run and its rows to the numpy oracle of the segment.
    Segment sharding: q2_family through QueryExecutor(mesh_devices=cuda:0
    x 4) (dp = 4): one dispatch, kernel A once a shard (each launch held
    against its plain version), one host fetch, the rows the oracle's; the
    family's packed buffer byte for byte the solo family's; a traced run's
    crossChipCombineMs and per-device stamps; SET meshExecution = false
    giving the same rows with one launch. Launches are counted from 0 just
    before each run and read just after. The native library: every LZ4 /
    Snappy buffer of the `ssbz` segments re-encoded by the library equal to
    the stored container, decoded by the library and by the port's Python
    codecs to the same bytes, and a 2^23-value bit-packed plane packed and
    unpacked by the library equal to the numpy versions; the MB/s of each
    (host, warm page cache)."""
    from pinot_tpu_torch.engine.query_executor import QueryExecutor
    from pinot_tpu_torch.ops import kernels
    from pinot_tpu_torch.ops.kernels import run_program
    from pinot_tpu_torch.parallel import mesh as pmesh
    from pinot_tpu_torch.query.parser.sql import parse_sql
    from pinot_tpu_torch.segment import bitpack, compression, native_bridge
    from pinot_tpu_torch.segment.loader import load_segment

    t_phase = time.perf_counter()
    out = {"phase": "mesh", "card": card}
    parity, rows = {}, []
    schema, segs = tables["ssb"]
    ex = qe.executor

    # -- row sharding: kernel B at four row offsets --------------------------
    seg = segs[0]
    query = parse_sql(Q2)
    plan = ex.plan(query, seg)
    view, arrays, params, packed, fused, lut_meta = ex.solo_inputs(seg, plan)
    if not fused:
        raise AssertionError("mesh: q2's plan is not in kernel B's scope")
    mesh = pmesh.make_mesh(devices=MESH_DEVICES)
    shards = pmesh.shard_segment_arrays(arrays, mesh, view.padded, plan.slots)
    _cuda.reset_launches()
    with recording(fg, "fused_limb_sums") as b_calls:
        t0 = time.perf_counter()
        merged = pmesh.run_program_row_sharded(
            plan.program, shards, params, seg.num_docs, view.padded, mesh,
            slots=plan.slots, fused=True, lut_meta=lut_meta, packed=packed)
        torch.cuda.synchronize()
        row_ms = (time.perf_counter() - t0) * 1e3
    b_launches = dict(_cuda.LAUNCHES)
    local = view.padded // len(MESH_DEVICES)
    offsets = [int(c[2][1]) for c in b_calls]
    if b_launches != {"limb_sums": 0, "fused_limb_sums": len(MESH_DEVICES)} \
            or offsets != [k * local for k in range(len(MESH_DEVICES))]:
        raise AssertionError(f"mesh row shards: launches {b_launches}, "
                             f"row offsets {offsets}")
    for k, rec in enumerate(b_calls):
        parity[f"fused_limb_sums/mesh_q2_rows/shard{k}"] = check_equal(
            torch, f"fused_limb_sums mesh q2 shard {k} (row offset "
            f"{offsets[k]})", fg.fused_limb_sums(*rec),
            fg.fused_limb_sums_plain(*rec))
    solo = run_program(plan.program, arrays, params, seg.num_docs,
                       view.padded, packed=packed, fused=True,
                       fused_lut_meta=lut_meta)
    for i, (got, want) in enumerate(zip(merged, solo)):
        if not torch.equal(got, want):
            raise AssertionError(f"mesh row shards: output {i} differs from "
                                 "the solo fused run")
    inter = ex.collect(query, seg, plan, kernels.pack_outputs(merged))
    got_rows = sorted([int(y), int(b), float(v)] for y, b, v in zip(
        inter.key_cols[0], inter.key_cols[1], inter.state_cols[0][0]))
    seg_cols = {c: seg.get_values(c) for c in ("d_year", "p_brand",
                                               "s_region", "lo_revenue")}
    if got_rows != sorted(q2_oracle(seg_cols)):
        raise AssertionError("mesh row shards: rows differ from the oracle")
    del seg_cols, solo, merged
    out["row_sharded"] = {
        "query": "q2", "segment_rows": seg.num_docs, "shards": len(b_calls),
        "row_offsets": offsets, "launches": b_launches, "groups":
        len(got_rows), "host_ms": row_ms}

    # -- segment sharding: q2_family over dp = 4 -----------------------------
    mqe = QueryExecutor(device=DEVICE, mesh_devices=MESH_DEVICES)
    mqe.add_table(schema, segs)
    mqe.execute_sql(Q2)  # uploads and stacks the shards
    torch.cuda.synchronize()
    _cuda.reset_launches()
    fetches = kernels.host_fetches()
    with recording(mxu, "limb_sums") as a_calls:
        resp = mqe.execute_sql(Q2)
        torch.cuda.synchronize()
    a_launches = dict(_cuda.LAUNCHES)
    fetched = kernels.host_fetches() - fetches
    if a_launches != {"limb_sums": len(MESH_DEVICES), "fused_limb_sums": 0} \
            or resp.num_device_dispatches != 1 or fetched != 1:
        raise AssertionError(
            f"mesh q2_family: launches {a_launches}, dispatches "
            f"{resp.num_device_dispatches}, host fetches {fetched}")
    _rows_equal("mesh q2_family", resp, expected["q2"], False)
    for k, rec in enumerate(a_calls):
        parity[f"limb_sums/mesh_q2_family/shard{k}"] = check_equal(
            torch, f"limb_sums mesh q2_family shard {k}",
            mxu.limb_sums(*rec), mxu.limb_sums_plain(*rec))
    plans = [mqe.executor.plan(query, s) for s in segs]
    sharded = mqe.executor.dispatch_plan_batch(segs, plans,
                                               mesh=(len(MESH_DEVICES),))
    solo_pack = mqe.executor.dispatch_plan_batch(segs, plans)
    if sharded.metas != solo_pack.metas \
            or not torch.equal(sharded.flat, solo_pack.flat):
        raise AssertionError("mesh q2_family: the sharded pack differs from "
                             "the solo family's bytes")
    pack_bytes = sharded.flat.numel()
    del sharded, solo_pack
    traced = mqe.execute_sql("SET trace = true; " + Q2)
    fam = [s["attributes"] for s in traced.trace_info
           if s.get("attributes", {}).get("meshDevices")]
    stamps = [(s["attributes"]["device"], s["attributes"]["deviceExecMs"])
              for s in traced.trace_info
              if str(s.get("operator", "")).startswith("mesh_device")]
    if len(fam) != 1 or len(stamps) != len(MESH_DEVICES):
        raise AssertionError(f"mesh q2_family trace: {fam}, {stamps}")
    _cuda.reset_launches()
    off = mqe.execute_sql("SET meshExecution = false; " + Q2)
    torch.cuda.synchronize()
    if dict(_cuda.LAUNCHES) != {"limb_sums": 1, "fused_limb_sums": 0}:
        raise AssertionError(f"meshExecution = false: {_cuda.LAUNCHES}")
    _rows_equal("mesh q2_family meshExecution = false", off, expected["q2"],
                False)
    p50 = {}
    for label, prefix in (("mesh", ""), ("solo",
                                         "SET meshExecution = false; ")):
        ts = []
        for _ in range(MESH_ITERS):
            t0 = time.perf_counter()
            mqe.execute_sql(prefix + Q2)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        p50[label] = float(np.median(ts))
    out["segment_sharded"] = {
        "query": "q2_family", "members": len(segs), "dp": len(MESH_DEVICES),
        "launches": a_launches, "dispatches": resp.num_device_dispatches,
        "host_fetches": fetched, "pack_bytes": pack_bytes,
        "pack_byte_identical": True,
        "crossChipCombineMs": fam[0]["crossChipCombineMs"],
        "deviceExecMs": fam[0]["deviceExecMs"],
        "mesh_device_stamps_ms": stamps, "p50_ms": p50,
        "iters": MESH_ITERS}
    rows.append(kernel_b_row(
        torch, fg, _cuda, b_calls, len(b_calls),
        max(v for k, v in parity.items() if "mesh_q2_rows" in k),
        f"mesh q2 row-sharded: the first {seg.num_docs}-row ssb segment's "
        f"raw planes split over {len(MESH_DEVICES)} shards on cuda:0, one "
        "launch a shard at its row offset"))
    rows.append(kernel_a_row(
        torch, mxu, _cuda, a_calls, len(a_calls),
        max(v for k, v in parity.items() if "mesh_q2_family" in k),
        f"mesh q2_family segment-sharded: the family of {len(segs)} ssb "
        f"segments split over dp = {len(MESH_DEVICES)} on cuda:0, one "
        "launch a shard"))
    del mqe, resp, traced, off

    # -- the native host library ---------------------------------------------
    t0 = time.perf_counter()
    native_bridge.get_lib()
    codecs = {}
    for d in formats_dirs:
        zseg = load_segment(d, verify=False)
        for name, entry in zseg.metadata.buffers.items():
            if len(entry) != 3 or entry[2] not in ("LZ4", "SNAPPY"):
                continue
            off_, size, codec = entry
            stored = bytes(zseg._data[off_:off_ + size])
            c = codecs.setdefault(codec, {"buffers": 0, "raw_bytes": 0,
                                          "stored_bytes": 0, "encode_s": 0.0,
                                          "decode_s": 0.0, "py_decode_s": 0.0})
            t1 = time.perf_counter()
            raw = compression.decompress_buffer(stored)
            t2 = time.perf_counter()
            again = compression.compress_buffer(raw, codec)
            t3 = time.perf_counter()
            os.environ["PINOT_TPU_DISABLE_NATIVE"] = "1"
            try:
                py_raw = compression.decompress_buffer(stored)
            finally:
                del os.environ["PINOT_TPU_DISABLE_NATIVE"]
            t4 = time.perf_counter()
            if again != stored or py_raw != raw:
                raise AssertionError(f"native {codec} {name}: re-encoded "
                                     f"{again == stored}, Python decode "
                                     f"{py_raw == raw}")
            c["buffers"] += 1
            c["raw_bytes"] += len(raw)
            c["stored_bytes"] += size
            c["decode_s"] += t2 - t1
            c["encode_s"] += t3 - t2
            c["py_decode_s"] += t4 - t3
        del zseg
    if set(codecs) != {"LZ4", "SNAPPY"}:
        raise AssertionError(f"ssbz native buffers: {sorted(codecs)}")
    for c in codecs.values():
        c["encode_mb_per_s"] = _mbps(c["raw_bytes"], c.pop("encode_s"))
        c["decode_mb_per_s"] = _mbps(c["raw_bytes"], c.pop("decode_s"))
        c["python_decode_mb_per_s"] = _mbps(c["raw_bytes"],
                                            c.pop("py_decode_s"))
        c["ratio"] = c["stored_bytes"] / c["raw_bytes"]
    rng = np.random.default_rng(args.seed)
    vals = rng.integers(0, 1 << NATIVE_PLANE_BITS, 1 << 23).astype(np.uint32)
    t1 = time.perf_counter()
    packed_plane = bitpack.pack(vals, NATIVE_PLANE_BITS)
    t2 = time.perf_counter()
    back = bitpack.unpack(packed_plane, NATIVE_PLANE_BITS, len(vals))
    t3 = time.perf_counter()
    os.environ["PINOT_TPU_DISABLE_NATIVE"] = "1"
    try:
        np_packed = bitpack.pack(vals, NATIVE_PLANE_BITS)
        t4 = time.perf_counter()
        np_back = bitpack.unpack(packed_plane, NATIVE_PLANE_BITS, len(vals))
        t5 = time.perf_counter()
    finally:
        del os.environ["PINOT_TPU_DISABLE_NATIVE"]
    if not (np.array_equal(packed_plane, np_packed)
            and np.array_equal(back, vals.astype(np.int32))
            and np.array_equal(np_back, back)):
        raise AssertionError("native bit packing differs from numpy's")
    plane_bytes = 4 * len(vals)
    out["native"] = {
        "library": native_bridge.library_path().name, "codecs": codecs,
        "bitpack": {"values": len(vals), "bits": NATIVE_PLANE_BITS,
                    "pack_mb_per_s": _mbps(plane_bytes, t2 - t1),
                    "unpack_mb_per_s": _mbps(plane_bytes, t3 - t2),
                    "numpy_pack_mb_per_s": _mbps(plane_bytes, t4 - t3),
                    "numpy_unpack_mb_per_s": _mbps(plane_bytes, t5 - t4)},
        "seconds": time.perf_counter() - t0}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return {"parity": parity, "rows": rows}


def phase_doctor(card, report) -> None:
    """The GPU probe's report (tools/doctor.py `run_probe`, its supervised
    child started while phase index_data waits on the build pool): it
    must classify `ok`."""
    if report["classification"] != "ok":
        raise AssertionError(f"doctor: {report['classification']}: "
                             f"{report['remedy']}\n{report['stderrTail']}")
    emit({"phase": "doctor", "card": card,
          "classification": report["classification"],
          "device": report["device"], "probe_s": report["elapsedS"]})


def phase_oom(torch, qe, expected, card) -> None:
    """Device-memory relief under a per-process cap
    (torch.cuda.set_per_process_memory_fraction). q4's 16 segments are made
    cold (their planes dropped from the card); the cap leaves room for a
    quarter of what q4 uploads beside everything still resident (the
    allocator's free blocks taken, `fill_free_blocks`), so q4 cannot run
    without eviction: one relief, rows equal to the oracle.
    Then, everything evicted, a cap 1 MiB above what is allocated and the
    allocator's free blocks taken (`fill_free_blocks`), below q4's own
    need: it fails alone with HbmExhaustedError, and under the lifted cap
    the next query answers. Prints the caps, the bytes freed and the
    relief time."""
    from pinot_tpu_torch.engine.oom import (HbmExhaustedError, oom_stats,
                                            reset_oom_stats)

    dcache = qe.executor.cache
    for s in qe.tables["ssb16"].segments:
        dcache.drop(s)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    out = {"phase": "oom", "card": card, "total_memory": total}
    try:
        need = dcache.bytes_used()
        qe.execute_sql(QUERIES["q4"])  # measures q4's uploads
        need = dcache.bytes_used() - need
        for s in qe.tables["ssb16"].segments:
            dcache.drop(s)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        cap = torch.cuda.memory_reserved() + need // 4
        torch.cuda.set_per_process_memory_fraction(cap / total)
        ballast = fill_free_blocks(torch)
        first_ballast = sum(b.numel() for b in ballast)
        reset_oom_stats()
        t0 = time.perf_counter()
        resp = qe.execute_sql(QUERIES["q4"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ballast = None
        _rows_equal("oom q4", resp, expected["q4"], False)
        st = oom_stats()
        if st["reliefs"] != 1 or st["failures"]:
            raise AssertionError(f"oom: {st}")
        out.update(q4_upload_bytes=need, cap_bytes=cap,
                   first_ballast_bytes=first_ballast,
                   fraction=cap / total, relieved=st, ms=ms,
                   resident_after=dcache.bytes_used(),
                   reserved_after=torch.cuda.memory_reserved())
        dcache.evict_all_except(None)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        low = torch.cuda.memory_allocated() + (1 << 20)
        torch.cuda.set_per_process_memory_fraction(low / total)
        ballast = fill_free_blocks(torch)
        reset_oom_stats()
        try:
            qe.execute_sql(QUERIES["q4"])
        except HbmExhaustedError as e:
            out.update(low_cap_bytes=low, failed_with=type(e).__name__,
                       failing=oom_stats(),
                       ballast_bytes=sum(b.numel() for b in ballast))
        else:
            raise AssertionError("oom: q4 answered under a cap below its "
                                 "need")
    finally:
        ballast = None
        torch.cuda.set_per_process_memory_fraction(1.0)
    t0 = time.perf_counter()
    resp = qe.execute_sql(QUERIES["q2_family"])
    torch.cuda.synchronize()
    _rows_equal("oom next query", resp, expected["q2_family"], False)
    out.update(next_query="q2_family", next_query_ms=(time.perf_counter()
                                                      - t0) * 1e3)
    emit(out)


def _has_join(node) -> bool:
    from pinot_tpu_torch.mse.logical import JoinNode

    return isinstance(node, JoinNode) or any(_has_join(i) for i in node.inputs)


def _stage_view(resp) -> dict:
    keep = ("workers", "leaf_pushdown", "rows_in", "rows_out", "join_impl",
            "host_crossings", "wall_ms", "device_partition_ms",
            "shuffled_bytes")
    return {str(k): {f: st[f] for f in keep}
            for k, st in resp.mse_stage_stats.items()}


def _op_cost(name: str, args: tuple, kwargs: dict):
    """(bytes, shape) of a join pipeline op: the bytes it must move, each
    input it reads once and each output it writes once (int64 codes,
    groups and plane entries, float64 values, bool masks)."""
    if name == "partition_planes":
        codes, n, P, cap = args[:4]
        return 8 * n + 8 * P * cap + 8 * P, {
            "n": n, "P": P, "cap": cap,
            "key_sorted": bool(kwargs.get("key_sorted"))}
    if name == "fused_join_agg":
        (pk, pg, pvals, pplane, pcounts, bk, bvals, bplane, bcounts, pn, bn,
         spec, P, Gp) = args
        vp = len({v for k, sd, v in spec if sd == "probe" and k != "count"})
        vb = len({v for k, sd, v in spec if sd == "build"})
        masks = sum(n for n, m in ((pn, kwargs.get("pmask")),
                                   (bn, kwargs.get("bmask"))) if m is not None)
        cap_l, cap_r = pplane.shape[1], bplane.shape[1]
        return (pn * (16 + 8 * vp) + bn * (8 + 8 * vb) + masks
                + 8 * P * (cap_l + cap_r) + 16 * P
                + 8 * Gp * (len(spec) + 3)), {
            "pn": pn, "bn": bn, "P": P, "cap_l": cap_l, "cap_r": cap_r,
            "Gp": Gp, "spec": [list(x) for x in spec],
            "join_type": kwargs.get("join_type", "INNER"),
            "masks": masks > 0}
    cols, idx, n, n_to, _device = args  # gather_stack
    return 8 * n + 8 * n * len(cols) + 8 * n_to * len(cols), {
        "n": n, "n_to": n_to, "cols": len(cols),
        "uploads_bytes": 8 * sum(len(c) for c in cols)}


def _tensors(rec):
    args, kwargs = rec
    return [x for x in list(args) + list(kwargs.values())
            if hasattr(x, "data_ptr")]


def _clone_call(torch, rec):
    """A recorded (args, kwargs) call with each tensor argument copied."""
    args, kwargs = rec

    def c(x):
        return clone_at(torch, x) if hasattr(x, "data_ptr") else x

    return tuple(c(x) for x in args), {k: c(v) for k, v in kwargs.items()}


def phase_mse(torch, qe, expected, _cuda, interp, mxu, iters, card) -> dict:
    """The multi-stage statements on the card. The main path first: each
    statement once, every count set to 0 just before it and read just
    after, its rows held against the numpy oracle, the fused stage (one
    host crossing, measured) of q8 / q9j / q10, every leaf on the
    single-stage path and one host fetch a leaf and a fused stage, the
    pair join's device calls of mse_pairs and kernel A under mse_agg. Then each statement's warm p50
    and its layer times (parse + plan; the leaf stages; the join stage;
    the rest: shuffles, final aggregate, sort, broker) over the same runs
    (a statement slower than 1 s: its main-path run, the planes resident);
    the join stages' torch ops of q8 and q10 alone against their bytes
    bound (`join_ops`); and one q8 with torch's sync debug mode on, counting
    the synchronizing calls inside its fused stage."""
    from pinot_tpu_torch.mse import device_join
    from pinot_tpu_torch.mse.parser import parse_relational
    from pinot_tpu_torch.ops import join_pipeline as jp

    results, per_query, fetches, calls, stages = {}, {}, {}, {}, {}
    agg_recs, first_ms = [], {}
    for qname, sql in MSE_QUERIES.items():
        leaves = {s.stage_id for s in qe.multistage.plan(parse_relational(sql))
                  if s.is_leaf}
        _cuda.reset_launches()
        fetch0 = interp.host_fetches()
        with recording(device_join, "device_join_indices") as pairs, \
                recording(device_join, "gather_payload") as gathers, \
                recording(device_join, "run_fused") as fused, \
                recording(mxu, "limb_sums") as a_calls:
            t0 = time.perf_counter()
            resp = qe.execute_sql(sql)
            torch.cuda.synchronize()
            first_ms[qname] = (time.perf_counter() - t0) * 1e3
        per_query[qname] = dict(_cuda.LAUNCHES)
        fetches[qname] = interp.host_fetches() - fetch0
        calls[qname] = {"device_join_indices": len(pairs),
                        "gather_payload": len(gathers),
                        "run_fused": len(fused)}
        if resp.exceptions:
            raise AssertionError(f"{qname}: {resp.exceptions}")
        got = [tuple(r) for r in resp.result_table.rows]
        want = [tuple(r) for r in expected[qname]]
        if qname == "mse_agg":
            got, want = sorted(got), sorted(want)
        if got != want:
            bad = next((a, b) for a, b in zip(got + [None] * len(want),
                                              want + [None] * len(got))
                       if a != b)
            raise AssertionError(f"{qname}: {len(got)} rows vs oracle "
                                 f"{len(want)}; first difference {bad}")
        st = resp.mse_stage_stats
        impls = {s["join_impl"] for s in st.values() if s["join_impl"]}
        crossings = sum(s["host_crossings"] for s in st.values())
        if qname in FUSED_MSE and (impls != {"device-fused"} or len(fused) != 1
                                   or crossings != 1):
            raise AssertionError(f"{qname}: join {impls}, {len(fused)} fused "
                                 f"stages, {crossings} host crossings")
        # every leaf ran on the single-stage engine, and the statement made
        # one host fetch for each leaf and each fused stage (measured)
        if not all(st[k]["leaf_pushdown"] for k in leaves):
            raise AssertionError(f"{qname}: a leaf of {sorted(leaves)} did "
                                 f"not push down: {_stage_view(resp)}")
        if fetches[qname] != len(leaves) + len(fused):
            raise AssertionError(f"{qname}: {fetches[qname]} host fetches, "
                                 f"{len(leaves)} leaves, {len(fused)} fused "
                                 "stages")
        if qname == "mse_pairs" and (not pairs or not gathers):
            raise AssertionError(f"mse_pairs: device join calls {calls}")
        if qname == "mse_agg":
            if per_query[qname]["limb_sums"] == 0:
                raise AssertionError("mse_agg did not launch limb_sums")
            agg_recs = list(a_calls)
        stages[qname] = _stage_view(resp)
        results[qname] = resp
    # F13: a shape the single-stage planner refuses (PERCENTILE over the
    # raw lo_revenue) through execute_sql with no SET: the multi-stage
    # engine answers it, its leaves scanning on the card
    from pinot_tpu_torch.query.parser.sql import parse_sql

    try:
        qe.execute(parse_sql(F13_SQL))
    except interp_unsupported() as e:
        refusal = str(e)
    else:
        raise AssertionError("f13: the single-stage planner did not refuse")
    _cuda.reset_launches()
    fetch0 = interp.host_fetches()
    t0 = time.perf_counter()
    resp = qe.execute_sql(F13_SQL)
    torch.cuda.synchronize()
    f13 = {"ms": (time.perf_counter() - t0) * 1e3, "refusal": refusal,
           "leaf_dispatches": resp.num_device_dispatches,
           "docs_scanned": resp.num_docs_scanned,
           "host_fetches": interp.host_fetches() - fetch0,
           "launches": dict(_cuda.LAUNCHES), "stages": _stage_view(resp)}
    if [list(r) for r in resp.result_table.rows] != expected["f13"] or \
            not resp.mse_stage_stats or resp.num_device_dispatches == 0 \
            or resp.num_docs_scanned != sum(
                seg.num_docs for seg in qe._table(FORMATS_TABLE).segments):
        raise AssertionError(f"f13: {resp.result_table.rows} against the "
                             f"oracle's {expected['f13']}, {f13}")
    emit({"phase": "mse", "oracle": "equal", "f13": f13,
          "rows_checked": {k: len(r.result_table.rows)
                           for k, r in results.items()},
          "mse_pairs_join_rows": expected["mse_pairs_total"],
          "launches_per_query": per_query, "host_fetches": fetches,
          "device_dispatches": {k: r.num_device_dispatches
                                for k, r in results.items()},
          "docs_scanned": {k: r.num_docs_scanned for k, r in results.items()},
          "pair_join_calls": calls, "stages": stages})

    p50, quartiles, docs, layers = {}, {}, {}, {}
    slow = {q for q, ms in first_ms.items() if ms > SLOW_QUERY_MS}
    for qname, sql in MSE_QUERIES.items():
        t0 = time.perf_counter()
        plan = qe.multistage.plan(parse_relational(sql))
        plan_ms = (time.perf_counter() - t0) * 1e3
        join_sids = {s.stage_id for s in plan if s.root is not None
                     and _has_join(s.root)}
        ts, parts = [], []

        def sample(resp, ms):
            st = resp.mse_stage_stats
            leaves = sum(s["wall_ms"] for s in st.values()
                         if s["leaf_pushdown"])
            join = sum(st[k]["wall_ms"] for k in join_sids if k in st)
            ts.append(ms)
            parts.append([leaves, join, ms - plan_ms - leaves - join])
            docs[qname] = resp.total_docs

        if qname in slow:
            sample(results[qname], first_ms[qname])
        while len(ts) < (1 if qname in slow else iters):
            t0 = time.perf_counter()
            resp = qe.execute_sql(sql)
            torch.cuda.synchronize()
            sample(resp, (time.perf_counter() - t0) * 1e3)
        p50[qname] = float(np.median(ts))
        quartiles[qname] = [float(q) for q in np.percentile(ts, [25, 75])]
        med = np.median(np.asarray(parts), axis=0)
        layers[qname] = {"parse_plan_ms": plan_ms, "leaves_ms": float(med[0]),
                         "join_stage_ms": float(med[1]),
                         "rest_ms": float(med[2])}
    emit({"phase": "mse_layers", "card": card, "iters": iters,
          "iters_1": sorted(slow), "layers": layers})

    # the join stages' device ops alone, on the inputs q8 and q10 gave them;
    # each call's tensors in an L2 pool, as the main path finds them
    ops = []
    for qname in ("q8", "q10"):
        with recording(jp, "partition_planes", with_kwargs=True) as parts, \
                recording(jp, "fused_join_agg", with_kwargs=True) as joins, \
                recording(jp, "gather_stack", with_kwargs=True) as stacks:
            qe.execute_sql(MSE_QUERIES[qname])
            torch.cuda.synchronize()
        for name, fn, recs in (("partition_planes", jp.partition_planes, parts),
                               ("fused_join_agg", jp.fused_join_agg, joins),
                               ("gather_stack", jp.gather_stack, stacks)):
            for k, (a, kw) in enumerate(recs):
                pool = l2_pool(
                    [(a, kw)],
                    lambda rec: sum(t.numel() * t.element_size()
                                    for t in _tensors(rec)),
                    lambda rec: _clone_call(torch, rec))
                fns = [lambda fn=fn, r=r: fn(*r[0], **r[1]) for r in pool]
                ms = device_ms(torch, fns, None, iters=5)
                run = fns[0]
                nbytes, shape = _op_cost(name, a, kw)
                bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops.append({"query": qname, "op": name, "call": k,
                            "source": "pinot_tpu_torch/ops/join_pipeline.py",
                            "ms": ms, "call_ms": cuda_ms(torch, run, 5),
                            "bytes": nbytes, "bound_ms": bound_ms,
                            "bound_share": bound_ms / ms if ms > 0 else None,
                            "shape": shape})
    stage_ms = {q: sum(o["ms"] for o in ops if o["query"] == q)
                for q in ("q8", "q10")}
    emit({"phase": "join_ops", "card": card, "ops": ops,
          "stage_device_ms": stage_ms,
          "share_of_p50": {q: stage_ms[q] / p50[q] for q in stage_ms},
          "hbm_bytes_per_s": HBM_BYTES_PER_S})

    # synchronizing calls inside q8's fused stage (informational): torch's
    # sync debug mode warns at each; the stages above the fused one run on
    # the host, so the warnings from its start on are its own
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught, \
                recording(device_join, "run_fused",
                          tag=lambda: len(caught)) as fused:
            warnings.simplefilter("always")
            qe.execute_sql(MSE_QUERIES["q8"])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message).split("\n")[0][:120]
             for w in caught[fused[0][1]:] if "synchroniz" in str(w.message)]
    emit({"phase": "sync_debug", "query": "q8", "fused_stages": len(fused),
          "synchronizing_calls": len(syncs), "first_messages": syncs[:6]})
    return {"p50": p50, "quartiles": quartiles, "slow": slow, "docs": docs,
            "agg_recs": agg_recs,
            "agg_launches": per_query["mse_agg"]["limb_sums"]}


def interp_unsupported():
    from pinot_tpu_torch.engine.aggregation import UnsupportedQueryError

    return UnsupportedQueryError


def phase_geometry(torch, _cuda, mxu, fg, recorded) -> None:
    """The launch geometry of each main-path shape, and how many clusters
    of each size the card holds at that shape's shared memory."""
    out = {}
    for qname, recs in recorded.items():
        segments = 1
        if qname in ("q2", "q9"):
            fp, planes_in, scalars, G, n = recs[0]
            name, P = "fused_limb_sums", len(fp.planes)
            layout, index = fg.slot_layout(planes_in), scalars.device.index
        else:
            planes, gid, G = recs[0]
            name, n, P = "limb_sums", gid.shape[-1], planes.shape[-2]
            segments = planes.shape[0] if planes.dim() == 3 else 1
            layout, index = mxu.slot_layout(planes, gid), gid.device.index
        geo = _cuda.geometry_for(name, n, P, G, *layout, index, segments)
        out[qname] = dict(geometry_of(geo), kernel=name, n=n, P=P, G=G,
                          active_clusters={c: _cuda.max_active_clusters(
                              name, c, geo.smem_bytes) for c in (1, 2, 4, 8)})
    emit({"phase": "geometry", "sms": torch.cuda.get_device_properties(0)
          .multi_processor_count, "shapes": out})


def phase_layers(torch, qe, iters, card, slow) -> dict:
    """Where a warm query's time goes, layer by layer, with the host clock:
    parse + prune + plan, dispatch (planes already resident; every family
    or segment, or the device combine; ends in torch.cuda.synchronize(), so
    it holds the device time), collect (the query's one device->host copy
    and the decode), combine + reduce. Medians over `iters` runs (1 for the
    queries in `slow`)."""
    from pinot_tpu_torch.engine.reduce import BrokerReducer
    from pinot_tpu_torch.query.parser.sql import parse_sql

    out = {}
    for qname, sql in QUERIES.items():
        if qname in HOST_HELD:
            continue
        ts = []
        for _ in range(1 if qname in slow else iters):
            t0 = time.perf_counter()
            query = parse_sql(sql)
            table = qe._table(query.table_name)
            segments, _ = qe.prune_segments(
                query, qe.pinned_segments(table.segments))
            routes = qe.route_segments(query, segments)
            plans = qe.plan_segments(routes)
            t1 = time.perf_counter()
            pending = qe.dispatch_segments(query, routes, plans)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            inter = qe.collect_segments(routes, plans, pending)
            t3 = time.perf_counter()
            BrokerReducer(table.schema).reduce(query, qe._combine(query, inter))
            t4 = time.perf_counter()
            ts.append([t1 - t0, t2 - t1, t3 - t2, t4 - t3])
        med = np.median(np.asarray(ts), axis=0) * 1e3
        out[qname] = dict(zip(("parse_plan_ms", "dispatch_ms", "collect_ms",
                               "combine_reduce_ms"), map(float, med)))
    emit({"phase": "layers", "card": card, "iters": iters,
          "iters_1": sorted(slow), "left_out": list(HOST_HELD),
          "layers": out})
    return out


def phase_profile(torch, qe, card) -> dict:
    """Device busy share of one warm run a query under torch.profiler (the
    queries are warm from `times` and `layers`; 2 runs and a warm-up before
    phase `timeseries` joined the run): the device time of every CUDA
    kernel over the host wall time, and the kernels that take the most of
    it."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for qname in (("q2", "q2_unfused", "flagship", "q2_family", "q3",
                   "q3_sort", "q3m", "sparse_family", "sparse_family_solo",
                   "q5", "q5_total", "aggmix", "sel_limit", "sel_order",
                   "mv_filter", "mv_group", "mv_aggs") + TRANSFORM_QUERIES
                  + ("post_agg",) + RT_KERNEL_QUERIES + ST_QUERIES
                  + INDEX_QUERIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            qe.execute_sql(QUERIES[qname])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device-side events only (kernels and copies): the CPU-side ops
        # that launched them carry the same time again
        device = [(e.key, e.self_device_time_total, e.count)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        busy_us = sum(d[1] for d in device)
        device.sort(key=lambda d: -d[1])
        out[qname] = {
            "runs": 1,
            "wall_ms_per_query": wall_us / 1e3,
            "device_ms_per_query": (busy_us / 1e3 if device
                                    else "not measured"),
            "device_busy_share": busy_us / wall_us if device else "not measured",
            "top_device": [{"name": k[:60], "ms_per_query": t / 1e3,
                            "calls_per_query": c}
                           for k, t, c in device[:6]]}
    emit({"phase": "profile", "card": card, "profile": out})
    return out


def phase_chain(torch, qe, interp, card) -> dict:
    """time_raw's filter chain, MONTH(lo_commit_ts), alone over the family's
    raw (4, padded) int64 plane: its time with CUDA events and its device
    time under torch.profiler (5 evaluations each), the torch kernels it
    launches (one per distinct op of the expression DAG), the bytes those
    eager ops move (each op reads its plane operands and writes its
    output), and the least time of one fused pass (read the plane once,
    write one byte a row), both over the card's memory rate."""
    from torch.profiler import ProfilerActivity, profile

    from pinot_tpu_torch.engine import ir
    from pinot_tpu_torch.engine.plan import SegmentPlanner
    from pinot_tpu_torch.query.parser.sql import parse_sql

    segs = qe._table(TIME_TABLE).segments
    planner = SegmentPlanner(parse_sql(QUERIES["time_raw"]), segs[0])
    node = planner.plan().program.filter
    if not isinstance(node, ir.Interval):
        raise AssertionError(f"time_raw's filter lowered to {node}")
    ve = node.vexpr
    raw = [(c, k) for c, k in planner._slots if k == "raw"]
    if raw != [("lo_commit_ts", "raw")]:
        raise AssertionError(f"time_raw's chain reads {raw}")
    slot = planner._slots.index(raw[0])
    plane = torch.stack([qe.executor.cache.view(s).raw("lo_commit_ts")
                         for s in segs])
    arrays = tuple(plane if i == slot else None
                   for i in range(len(planner._slots)))
    params = tuple(torch.from_numpy(np.array(p)).to(DEVICE).reshape(1, -1)
                   for p in planner._params)

    memo, cost = {}, {"ops": 0, "bytes": 0}

    def ev(n):
        if id(n) not in memo:
            out = interp._eval_node(n, arrays, params, ev)
            kids = [memo[id(c)] for c in interp._children(n)]
            if kids and not any(out is k for k in kids):
                cost["ops"] += 1
                cost["bytes"] += out.numel() * out.element_size() + sum(
                    k.numel() * k.element_size() for k in kids
                    if k.numel() == out.numel())
            memo[id(n)] = out
        return memo[id(n)]

    month = ev(ve)
    want = ((plane // DAY_MS).cpu().numpy().astype("datetime64[D]")
            .astype("datetime64[M]").astype(np.int64) % 12 + 1)
    if not np.array_equal(month.cpu().numpy(), want):
        raise AssertionError("MONTH(lo_commit_ts) on the card differs from "
                             "numpy's calendar")
    del memo, month
    torch.cuda.empty_cache()
    ms = cuda_ms(torch, lambda: interp._eval_value(ve, arrays, params), 5)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            interp._eval_value(ve, arrays, params)
        torch.cuda.synchronize()
    device = [(e.key, e.self_device_time_total, e.count)
              for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    device.sort(key=lambda d: -d[1])
    rows = plane.numel()
    out = {"phase": "chain", "card": card, "expr": "MONTH(lo_commit_ts)",
           "rows": rows, "ops": cost["ops"], "eager_bytes": cost["bytes"],
           "eager_bound_ms": cost["bytes"] / HBM_BYTES_PER_S * 1e3,
           "fused_bound_ms": rows * 9 / HBM_BYTES_PER_S * 1e3,
           "ms": ms,
           "device_ms": sum(d[1] for d in device) / 5 / 1e3,
           "kernels_per_eval": sum(d[2] for d in device) / 5,
           "top_device": [{"name": k[:60], "ms_per_eval": t / 5 / 1e3,
                           "calls_per_eval": c / 5}
                          for k, t, c in device[:6]]}
    emit(out)
    return out


def cuda_ms(torch, fn, iters=20) -> float:
    """Mean time of fn() with CUDA events around `iters` calls, after a
    warm-up: what a caller waits for, the host's launch work included."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# profiler windows device_ms may take to see its launches (5 before phase
# host_engine joined the run; the profiler has kept as few as 17 of 100
# launch events of one kernel A row in 5)
PROFILE_WINDOWS = 10


def device_ms(torch, fns, kernel, iters=20):
    """The kernel's own device time per launch: torch.profiler's
    self_device_time_total of the CUDA kernel named `kernel`, over `iters`
    calls cycling through `fns` (one per input of the row's L2 pool). The profiler
    may drop some of a window's kernel events: the mean is over the events
    it kept, gathered over up to PROFILE_WINDOWS windows until `iters` are
    in. With
    `kernel` None: every CUDA event of one window (an op of several kernels
    and copies), per call."""
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    total_us, count, seen = 0.0, 0, set()
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and (kernel is None or kernel_name(e.key) == kernel)):
                total_us += e.self_device_time_total
                count += e.count
                seen.add(e.key)
        if kernel is None:
            return total_us / 1e3 / iters
        if count >= iters:
            break
    if count < iters:
        raise AssertionError(f"profiler saw {count} launches of {kernel} "
                             f"in {PROFILE_WINDOWS} windows of {iters}: "
                             f"{sorted(seen)}")
    return total_us / 1e3 / count


def kernel_name(key: str):
    """Which of the port's kernels a profiler event key names, if any."""
    if "fused_limb_sums_kernel" in key:
        return "fused_limb_sums"
    if "limb_sums_kernel" in key:
        return "limb_sums"
    return None


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def geometry_of(geo) -> dict:
    return {"mode": geo.mode, "cluster": geo.cluster, "clusters": geo.clusters,
            "table_planes": geo.table_planes, "table_groups": geo.table_groups,
            "tile_rows": geo.tile_rows, "stages": geo.stages,
            "stage_bytes": geo.stage_bytes, "smem_bytes": geo.smem_bytes,
            "iters": geo.iters, "tail_rows": geo.tail_rows,
            "warp_agg": geo.warp_agg}


def rotating(fns):
    """One callable taking fns in turn."""
    k = iter(range(1 << 30))
    return lambda: fns[next(k) % len(fns)]()


def clone_at(torch, t):
    """A contiguous copy of t at t's address modulo 16 (the kernels choose
    their vector loads by the planes' alignment)."""
    nb = t.numel() * t.element_size()
    buf = torch.empty(nb + 16, dtype=torch.uint8, device=t.device)
    off = (t.data_ptr() - buf.data_ptr()) % 16
    out = buf[off:off + nb].view(t.dtype).view(t.shape)
    out.copy_(t)
    return out


def l2_pool(recs, nbytes, clone):
    """recs, with fresh copies of them added in turn while an input could
    still sit in the card's L2 when a rotation over the pool comes back to
    it: until the rest of the pool moves at least twice L2 between two uses
    of any one input, unless each input alone is larger than L2."""
    pool = list(recs)
    sizes = [nbytes(r) for r in pool]
    while min(sizes) < L2_BYTES and sum(sizes) - max(sizes) < 2 * L2_BYTES:
        pool.append(clone(recs[len(pool) % len(recs)]))
        sizes.append(nbytes(pool[-1]))
    return pool


def kernel_row(torch, name, calls, plains, libraries, cost, padded_cost,
               shape, launches, err, note, geo, redesigned="PR 3") -> dict:
    """One row of the kernel table. `calls`, `plains` and `libraries` are
    the kernel's wrapper, its plain version and the library call on each
    input of the L2 pool in turn (the recorded inputs of each segment or
    family and their copies); `cost` is the (bytes, operations) of the
    rows the function needs, `padded_cost` that of the whole padded input
    the kernel is given."""
    ms = device_ms(torch, calls, name)
    call_ms = cuda_ms(torch, rotating(calls))
    plain_ms = cuda_ms(torch, rotating(plains), 5)
    lib_ms = cuda_ms(torch, rotating(libraries), 5)
    bound_ms, by = bound(*cost)
    src = {"limb_sums": ("pinot_tpu_torch/csrc/limb_sums.cu",
                         "pinot_tpu/ops/mxu_groupby.py:211"),
           "fused_limb_sums": ("pinot_tpu_torch/csrc/fused_limb_sums.cu",
                               "pinot_tpu/ops/fused_groupby.py:314")}[name]
    return {"name": name, "route": "cuda", "source": src[0], "replaces": src[1],
            "launches": launches, "max_abs_err": err, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "bound_share": bound_ms / ms,
            "padded_bound_ms": bound(*padded_cost)[0],
            "library_ms": lib_ms, "shape": shape, "inputs": note,
            "rotated_inputs": len(calls),
            "geometry": geometry_of(geo), "redesigned": redesigned}


def kernel_a_row(torch, mxu, _cuda, recs, launches, err, note, live=None):
    """Kernel A over the recorded (planes, gid, G) of each segment, or of
    each family ((S, P, n) planes: the family axis). `live` is the live rows
    of each member (default n: a segment that fills its pad bucket); the
    bound counts those, the pad rows past them carrying the trash gid."""
    planes, gid, G = recs[0]
    family = planes.dim() == 3
    S, (P, n) = (planes.shape[0] if family else 1), planes.shape[-2:]
    live = list(live) if live is not None else [n] * S
    pool = l2_pool(recs, lambda r: r[0].numel() + 4 * r[1].numel(),
                   lambda r: (clone_at(torch, r[0]), clone_at(torch, r[1]),
                              r[2]))
    calls = [lambda r=r: mxu.limb_sums(*r) for r in pool]
    plains = [lambda r=r: mxu.limb_sums_plain(*r) for r in pool]

    # the library yardstick: one index_add_ over the family's rows, member
    # s's groups at s * G
    def library(r):
        flat = (r[1].to(torch.int64).reshape(S, n) + G * torch.arange(
            S, device=DEVICE).unsqueeze(1)).reshape(-1)
        planes64 = r[0].reshape(S, P, n).transpose(0, 1).reshape(
            P, S * n).to(torch.int64)
        return lambda: torch.zeros((P, S * G), dtype=torch.int64,
                                   device=DEVICE).index_add_(1, flat, planes64)

    geo = _cuda.geometry_for("limb_sums", n, P, G,
                             *mxu.slot_layout(planes, gid), gid.device.index, S)
    shape = {"n": n, "P": P, "G": G}
    if family:
        shape["S"] = S
    if live != [n] * S:
        shape["live_rows"] = live
    return kernel_row(
        torch, "limb_sums", calls, plains, [library(r) for r in pool],
        (sum(live) * (4 + P) + S * 8 * P * G, sum(live) * P),
        (S * (n * (4 + P) + 8 * P * G), S * n * P), shape, launches, err,
        note, geo, "PR 3; family axis PR 4" if family else "PR 3")


def fused_live(scalars, n) -> int:
    """Kernel B's rows below num_docs: row r is live when r + scalars[1] <
    scalars[0] (fused_groupby.fused_planes)."""
    num_docs, offset = scalars[:2].tolist()
    return max(0, min(n, num_docs - offset))


def fused_cost(fp, planes_in, n, G):
    width = sum(t.element_size() for t in planes_in)
    runs = sum(t[3] if t[0] == "runs" else 1 for t in fp.terms)
    P = len(fp.planes)
    ops = n * (1 + 2 * runs + 2 * len(fp.groups) + 4 * P)
    return n * width + 8 * P * G, ops


def kernel_b_row(torch, fg, _cuda, recs, launches, err, note):
    """Kernel B over the recorded (fp, planes_in, scalars, G, n) of each
    segment; the bound counts the rows below num_docs (the kernel streams
    every tile of n and masks the rest)."""
    fp, planes_in, scalars, G, n = recs[0]
    pool = l2_pool(recs, lambda r: sum(t.numel() * t.element_size()
                                       for t in r[1]),
                   lambda r: (r[0], [clone_at(torch, t) for t in r[1]],
                              r[2].clone(), r[3], r[4]))
    calls = [lambda r=r: fg.fused_limb_sums(*r) for r in pool]
    plains = [lambda r=r: fg.fused_limb_sums_plain(*r) for r in pool]

    def library(r):
        gid64, vals = fg.fused_planes(*r)
        return lambda: torch.zeros((P, G), dtype=torch.int64, device=DEVICE
                                   ).index_add_(1, gid64, vals)

    P = len(fp.planes)
    live = fused_live(scalars, n)
    nbytes, ops = fused_cost(fp, planes_in, live, G)
    padded_bytes, padded_ops = fused_cost(fp, planes_in, n, G)
    geo = _cuda.geometry_for("fused_limb_sums", n, P, G,
                             *fg.slot_layout(planes_in), scalars.device.index)
    shape = {"n": n, "P": P, "G": G,
             "slot_bytes_per_row": sum(t.element_size() for t in planes_in)}
    if live != n:
        shape["live_rows"] = live
    return kernel_row(
        torch, "fused_limb_sums", calls, plains, [library(r) for r in pool],
        (nbytes + 4 * scalars.numel(), ops),
        (padded_bytes + 4 * scalars.numel(), padded_ops), shape,
        launches, err, note, geo)


def family_inputs(torch, S, n, P, G, seed, live=None):
    """S members' kernel A inputs (S, P, n) / (S, n); member s keeps
    live[s] rows, the rest carrying the trash gid and zero payloads as its
    pad rows would."""
    planes, gid = limb_inputs(torch, S * n, P, G, seed)
    planes = planes.view(P, S, n).transpose(0, 1).contiguous()
    gid = gid.view(S, n).contiguous()
    for s, rows in enumerate(live or ()):
        gid[s, rows:] = G - 1
        planes[s, :, rows:] = 0
    return planes, gid


def phase_family_edges(torch, mxu, geometry, _cuda, seed) -> dict:
    """Kernel A with its family axis at its edges, each one launch and
    element-equal to the plain version of the flattened family: a family
    of one, 16 members of a ragged n (padded to 16 bytes) with ragged live
    rows, a member with no live row, each segment's tiles spread over the
    card's CTAs, and one cluster whose range crosses every segment (its
    tables flushed at each new segment)."""
    out = {}
    n20 = (1 << 20) + 5
    cases = {
        "S1": (1, 1 << 22, 4, 7001, None, None),
        "S16_ragged": (16, n20, 4, 7001,
                       [n20 - 61_441 * s for s in range(16)], None),
        "member_n0": (4, 1 << 20, 4, 1001, [1 << 20, 0, 1 << 19, 17], None),
        "split_over_ctas": (2, 1 << 23, 4, 7001, None, None),
        "one_cluster": (6, 1 << 20, 4, 7001, None, "one_cluster"),
    }
    for label, (S, n, P, G, live, occupancy) in cases.items():
        planes, gid = family_inputs(torch, S, n, P, G, seed, live)
        before = _cuda.LAUNCHES["limb_sums"]
        if occupancy is None:
            got = mxu.limb_sums(planes, gid, G)
        else:
            geo = geometry.plan(
                n, P, G, *mxu.slot_layout(planes, gid), segments=S,
                active_clusters=lambda c, smem: min(
                    1, _cuda.max_active_clusters("limb_sums", c, smem)))
            if geo.clusters != 1 or geo.units < S:
                raise AssertionError(f"{label}: {geo}")
            got = mxu.launch(planes, gid, G, geo)
        if _cuda.LAUNCHES["limb_sums"] != before + 1:
            raise AssertionError(f"{label}: not one launch for the family")
        out[f"limb_sums/family_{label}"] = check_equal(
            torch, f"limb_sums family {label}", got,
            mxu.limb_sums_plain(planes, gid, G))
        del planes, gid, got
    torch.cuda.empty_cache()
    return out


def phase_edges(torch, mxu, fg, geometry, _cuda, seed) -> dict:
    """The kernels at the edges of the new geometry, each element-equal to
    its plain version (or, for the saturation cases, to the exact sum)."""
    out = {}
    one_tile = geometry.tile_rows_for((4, 1, 1))
    for label, (n, P, G) in {"n0": (0, 2, 10), "below_one_tile": (1000, 2, 10),
                             "one_tile": (one_tile, 2, 10),
                             "one_tile_plus_3": (one_tile + 3, 2, 10)}.items():
        planes, gid = limb_inputs(torch, n, P, G, seed)
        out[f"limb_sums/{label}"] = check_equal(
            torch, f"limb_sums {label}", mxu.limb_sums(planes, gid, G),
            mxu.limb_sums_plain(planes, gid, G))

    def only(name, cluster=None):
        return lambda c, smem: (0 if cluster is not None and c != cluster
                                else min(1, _cuda.max_active_clusters(name, c, smem)))

    n = (1 << 25) + 5
    for label, (P, G, occupancy) in {
            "saturation": (1, 1, None),
            "saturation_one_cta": (1, 1, only("limb_sums", 1)),
            "saturation_one_cluster": (8, 7001, only("limb_sums"))}.items():
        planes = torch.full((P, n), 127, dtype=torch.int8, device=DEVICE)
        gid = torch.zeros(n, dtype=torch.int32, device=DEVICE)
        if occupancy is None:
            got = mxu.limb_sums(planes, gid, G)
        else:
            geo = geometry.plan(n, P, G, *mxu.slot_layout(planes, gid),
                                active_clusters=occupancy)
            if geo.iters <= geo.epoch_iters:
                raise AssertionError(f"{label}: no flush mid-run in {geo}")
            got = mxu.launch(planes, gid, G, geo)
        want = torch.zeros((P, G), dtype=torch.int64, device=DEVICE)
        want[:, 0] = 127 * n
        out[f"limb_sums/{label}"] = check_equal(torch, f"limb_sums {label}",
                                                got, want)
        del planes, gid
    u8 = torch.zeros(n, dtype=torch.uint8, device=DEVICE)
    val = torch.full((n,), 127, dtype=torch.int32, device=DEVICE)
    fp = fg.FusedPlan((), ((0, 1),), (("count",), ("limb", 1, 0)), (), (0, 1))
    scal = torch.tensor([n, 0], dtype=torch.int32, device=DEVICE)
    want = torch.tensor([[n], [127 * n]], dtype=torch.int64, device=DEVICE)
    out["fused_limb_sums/saturation"] = check_equal(
        torch, "fused_limb_sums saturation",
        fg.fused_limb_sums(fp, (u8, val), scal, 1, n), want)
    geo = geometry.plan(n, 2, 1, *fg.slot_layout((u8, val)),
                        active_clusters=only("fused_limb_sums", 1))
    out["fused_limb_sums/saturation_one_cta"] = check_equal(
        torch, "fused_limb_sums saturation one CTA",
        fg.launch(fp, (u8, val), scal, 1, geo), want)
    del u8, val
    for label, n in {"n0": 0, "below_one_tile": 1000,
                     "ragged": (1 << 20) + 3}.items():
        fp, planes_in, scal, G, _ = synthetic_fused_cases(torch, fg, seed, n)["interval"]
        out[f"fused_limb_sums/{label}"] = check_equal(
            torch, f"fused_limb_sums {label}",
            fg.fused_limb_sums(fp, planes_in, scal, G, n),
            fg.fused_limb_sums_plain(fp, planes_in, scal, G, n))
    torch.cuda.empty_cache()
    return out


def _hist_programs(ir, bins_fixed, bins_adaptive, groups):
    """A HISTOGRAM over [lo, hi] = params 0 and 1 of the float64 plane 0,
    and the adaptive percentile histogram of the rebased float32 plane 2
    over params 2 and 3, both grouped by the int32 plane 1."""
    fixed = ir.AggOp("hist_fixed", vexpr=ir.Col(0), bins=bins_fixed,
                     lo_param=0, hi_param=1)
    adaptive = ir.AggOp("hist_adaptive", vexpr=ir.Col(2), bins=bins_adaptive,
                        lo_param=2, hi_param=3, pct=99.0, prebased=True)
    return ir.Program(mode="group_by", filter=None, aggs=(fixed, adaptive),
                      group_slots=(1,), group_strides=(1,), num_groups=groups)


def phase_bin_edges(torch, interp, seed) -> dict:
    """The histogram bins on the card against the port's CPU run of the
    same program on the same inputs, element-equal (the CPU tests hold the
    CPU run to the JAX package's compiled program): the values whose bins
    an IEEE division of the widths moves (HISTOGRAM(x, 0, 3, 10) of 0.3,
    0.6, ..., 2.7; the rebased 31.226402 over [-30.9284687, 29.63817787]
    with 17 bins, fine bin 12 of bucket 8), then 2^22 values on and near
    bin edges in 1900 groups (kernel A counts the adaptive passes)."""
    from pinot_tpu_torch.engine import ir

    def run(program, host, nd, params):
        outs = {}
        for dev in ("cpu", DEVICE):
            arrays, tparams = interp.planes_from_numpy(host, params, dev)
            outs[dev] = [o.cpu() for o in interp.run_program(
                program, arrays, tparams, nd, len(host[0]), device=dev)]
        return outs

    out = {}
    padded = 8192
    x = np.zeros(padded)
    x[:8] = [0.3, 0.6, 0.7, 0.9, 1.5, 2.1, 2.4, 2.7]
    v = np.zeros(padded, np.float32)
    v[:8] = np.float32(31.226402)
    params = (np.float64(0.0), np.float64(3.0), np.float64(-30.9284687),
              np.float64(29.63817787))
    outs = run(_hist_programs(ir, 10, 17, 1),
               (x, np.zeros(padded, np.int32), v), 8, params)
    fixed, adaptive = outs[DEVICE][1][0], outs[DEVICE][2][0]
    if fixed.tolist() != [1, 1, 2, 0, 1, 0, 1, 1, 0, 1]:
        raise AssertionError(f"HISTOGRAM edge bins on the card: {fixed}")
    if int(adaptive[34]) != 8 or int(adaptive[17 + 12]) != 8:
        raise AssertionError(f"adaptive bins on the card: {adaptive}")
    big = []
    rng = np.random.default_rng(seed)
    n = 1 << 22
    x = rng.integers(0, 31, n) * 0.1 + rng.choice([0.0, 1e-12, -1e-12], n)
    gid = rng.integers(0, 1900, n).astype(np.int32)
    span = 29.63817787 + 30.9284687
    v = (rng.integers(0, 289 * 4, n) * (span / (289 * 4))).astype(np.float32)
    big = run(_hist_programs(ir, 10, 17, 1900), (x, gid, v), n, params)
    for label, o in (("edges", outs), ("edges_2^22", big)):
        for i, (got, want) in enumerate(zip(o[DEVICE], o["cpu"])):
            out[f"bins/{label}/output{i}"] = check_equal(
                torch, f"bins {label} output {i}", got, want)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--rows-per-segment", type=int, default=1 << 23)
    ap.add_argument("--segments", type=int, default=4)
    ap.add_argument("--iters", type=int, default=3)
    # 2^20 before phase host_engine joined the run: the JSON and text
    # index builds are host Python, and phase index_data waits for them
    # after phase data
    ap.add_argument("--events-rows", type=int, default=1 << 19,
                    help="rows of each of the 4 `events` segments")
    ap.add_argument("--vec-rows", type=int, default=1 << 16,
                    help="rows of each of the 4 `vecs` segments")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    os.environ["PINOT_TPU_MAX_ROWS_IN_JOIN"] = str(MAX_ROWS_IN_JOIN)
    # every phase but `cache` runs uncached: a warm run must dispatch, so
    # the launches, dispatches, fetches and p50s mean what they measured
    # before the caches existed
    os.environ["PINOT_TPU_SEGMENT_CACHE"] = "0"
    os.environ["PINOT_TPU_RESULT_CACHE"] = "0"

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA H100", file=sys.stderr)
        return 2
    try:
        from pinot_tpu_torch.engine.query_executor import QueryExecutor
        from pinot_tpu_torch.ops import (_cuda, fused_groupby, geometry,
                                         kernels as interp, mxu_groupby)
        from pinot_tpu_torch.tools import doctor
        from pinot_tpu_torch.utils.sketches import HyperLogLog
    except ImportError as e:
        print(f"chip_smoke: the pinot_tpu_torch package is missing ({e}); "
              "run from the repository root", file=sys.stderr)
        return 2

    dev = phase_device(torch)
    phase_build(_cuda)

    # -- parity: each kernel against its plain version, on the card -------
    parity = {}
    for label, (n, P, G) in {"q2_shape": (1 << 23, 4, 7001),
                             "q9_shape": (1 << 23, 8, 7001),
                             "G32768_P1": (1 << 23, 1, 32768),
                             "P24_G128": (1 << 23, 24, 128),
                             "P24_G1001": (1 << 23, 24, 1001),
                             "P16_G32768": (1 << 21, 16, 32768),
                             "ragged_n": ((1 << 23) - 12345, 5, 1001),
                             "G1": (100_003, 3, 1)}.items():
        planes, gid = limb_inputs(torch, n, P, G, args.seed)
        err = check_equal(torch, f"limb_sums {label}",
                          mxu_groupby.limb_sums(planes, gid, G),
                          mxu_groupby.limb_sums_plain(planes, gid, G))
        parity[f"limb_sums/{label}"] = err
        del planes, gid
    for label, (fp, planes_in, scal, G, n) in synthetic_fused_cases(
            torch, fused_groupby, args.seed).items():
        parity[f"fused_limb_sums/{label}"] = check_equal(
            torch, f"fused_limb_sums {label}",
            fused_groupby.fused_limb_sums(fp, planes_in, scal, G, n),
            fused_groupby.fused_limb_sums_plain(fp, planes_in, scal, G, n))
    parity.update(phase_edges(torch, mxu_groupby, fused_groupby, geometry,
                              _cuda, args.seed))
    parity.update(phase_family_edges(torch, mxu_groupby, geometry, _cuda,
                                     args.seed))
    # kernel A at one plane over the family of 4, at the G of every count
    # pass of the matrix-shaped aggregations (q5 / q5_total / aggmix)
    for G in (731, 5841, 32121, 9, 65, 7001, 78, 449):
        planes, gid = family_inputs(torch, args.segments,
                                    args.rows_per_segment, 1, G, args.seed)
        parity[f"limb_sums/P1_G{G}_family"] = check_equal(
            torch, f"limb_sums P = 1, G = {G}, family",
            mxu_groupby.limb_sums(planes, gid, G),
            mxu_groupby.limb_sums_plain(planes, gid, G))
        del planes, gid
    torch.cuda.empty_cache()

    parity.update(phase_bin_edges(torch, interp, args.seed))
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        with ProcessPoolExecutor(INDEX_WORKERS, mp_context=multiprocessing
                                 .get_context("spawn")) as pool:
            pending = submit_index_builds(args, tmp, pool)
            tables, dim, cols, dates, tags, taxi_cols = phase_data(
                args, torch, tmp, pool)
            # the batch job's input files, behind the data builds that
            # phase `data` waits for
            batch_inputs = submit_batch_inputs(args, tmp, pool)
            formats_parts = formats_columns(cols, min(
                FORMATS_ROWS, args.rows_per_segment * args.segments
                // (FORMATS_SEGMENTS * FORMATS_SEGMENTS)))
            formats_dirs = [f"{tmp}/{FORMATS_TABLE}_{i}"
                            for i in range(FORMATS_SEGMENTS)]
            formats_pending = [pool.submit(build_formats_segment, (
                i, part, d)) for i, (part, d) in enumerate(zip(
                    formats_parts, formats_dirs))]
            # the GPU probe's child runs while index_data waits on the
            # pool (it ran after batch_ingest, 9.2 s, before phase soak
            # joined the run); phase doctor reads its report
            with ThreadPoolExecutor(1) as probe:
                probed = probe.submit(doctor.run_probe, timeout_s=300)
                index, index_expected, facts = index_tables(
                    args, cols, tmp, pool, pending)
                doctor_report = probed.result()
            formats_build_s = sum(f.result()[1] for f in formats_pending)
            for fut in batch_inputs:
                fut.result()
        segments = tables["ssb"][1]
        expected = oracle(cols)
        rt_base = rt_partials(cols)
        expected.update(matrix_oracle(cols, HyperLogLog))
        expected.update(taxi_oracle(taxi_cols))
        expected.update(selection_mv_oracle(cols, tags,
                                            args.rows_per_segment))
        expected.update(transform_oracle(cols, dates))
        expected.update(timeseries_oracle(cols, dates))
        expected.update(mse_oracle(cols))
        expected["mse_agg"] = expected["q2"]
        expected["f13"] = f13_oracle({c: np.concatenate(
            [p[c] for p in formats_parts]) for c in ("s_region",
                                                     "lo_revenue")})
        del cols, taxi_cols, tags, dates
        tables.update(index)
        expected.update(index_expected)
        expected.update({"st_q2": expected["q2"], "st_q9": expected["q9"],
                         "st_bypass": expected["q1"]})
        QUERIES["ix_vec"] = VEC_QUERY.format(", ".join(
            f"{float(x):.9g}" for x in facts["vec_query"]))
        expected["ix_vec"] = vec_cpu_rows(*tables[VEC_TABLE])
        qe = QueryExecutor(device=DEVICE)
        for schema, segs in tables.values():
            qe.add_table(schema, segs)
        qe.add_dimension_table(*dim)
        t0 = time.perf_counter()
        warmed = sum(qe.executor.cache.warm(s) for s in tables[TAXI_TABLE][1])
        torch.cuda.synchronize()
        emit({"phase": "warm", "table": TAXI_TABLE, "planes": warmed,
              "seconds": time.perf_counter() - t0,
              "resident_bytes": qe.executor.cache.bytes_used()})
        launches, per_query, results = phase_queries(torch, qe, expected,
                                                     _cuda, interp)
        timeseries = phase_timeseries(args, torch, qe, expected, _cuda,
                                      mxu_groupby, fused_groupby,
                                      dev["nvidia_smi"])
        for qname, err in timeseries["parity"].items():
            parity[f"limb_sums/{qname}_inputs/family"] = err
        phase_index_checks(qe, results, facts, dev["nvidia_smi"])
        formats = phase_segment_formats(
            args, torch, qe, formats_dirs, formats_parts, formats_build_s,
            _cuda, mxu_groupby, fused_groupby, dev["nvidia_smi"])
        parity.update(formats["parity"])
        del formats_parts
        rt_final, rt_launches, rt_state = phase_realtime(
            args, torch, qe, tables, rt_base, interp, tmp, dev["nvidia_smi"])
        # the realtime queries at their final state join every later phase
        QUERIES.update(RT_QUERIES)
        EXPECTED_KERNEL.update({q: "limb_sums" for q in RT_KERNEL_QUERIES})
        expected.update(rt_final)
        _, rt_per_query, _ = phase_queries(torch, qe, expected, _cuda,
                                           interp, names=list(RT_QUERIES))
        per_query.update(rt_per_query)
        # realtime tables fed from a stream through the managers
        ingest = phase_ingest(args, torch, qe, interp, mxu_groupby,
                              fused_groupby, tmp, dev["nvidia_smi"])
        for qname, (recs, _) in ingest.items():
            for k, (name, _, _, err) in enumerate(recs):
                parity[f"{name}/ingest_{qname}_inputs/launch{k}"] = err
        mse = phase_mse(torch, qe, expected, _cuda, interp, mxu_groupby,
                        args.iters, dev["nvidia_smi"])
        expected.update(phase_cache(args, torch, qe, expected, interp,
                                    rt_state, dev["nvidia_smi"]))
        del rt_state
        # kernel A as a coalesced group of q2_family launches it: S * Q
        # members, Q = 8 and 16 queries
        group_inputs = phase_coalesce(torch, qe, expected, mxu_groupby,
                                      dev["nvidia_smi"])
        for q, (planes, gid, G) in group_inputs.items():
            parity[f"limb_sums/q2_family_group{q}_inputs"] = check_equal(
                torch, f"limb_sums q2_family group of {q} queries, "
                f"{planes.shape[0]} members", mxu_groupby.limb_sums(
                    planes, gid, G),
                mxu_groupby.limb_sums_plain(planes, gid, G))
        torch.cuda.empty_cache()
        phase_explain(torch, qe, expected, dev["nvidia_smi"])
        host_engine = phase_host_engine(
            args, torch, qe, tables, expected, _cuda, mxu_groupby,
            fused_groupby, tmp, dev["nvidia_smi"])
        for qname, err in host_engine["parity"].items():
            parity[f"limb_sums/host_engine_{qname}_inputs/family"] = err
        # phase host_engine's launches under backend "auto": kernel A over
        # the family of the 4 `clicks` segments for each query the device
        # plans, and over ssb_rt's committed family beside the snapshot the
        # host engine answers; timed right after the phase (timed at the
        # end of a run, the profiler kept 17 of 100 of these launches'
        # events once)
        host_rows = []
        for qname, rec in host_engine["recs"].items():
            what = (f"the family of the {INDEX_SEGMENTS} `{CLICKS_TABLE}` "
                    "segments" if qname != "rt_auto" else
                    f"`{RT_TABLE}`'s committed family of {len(segments)} "
                    "segments (its consuming snapshot on the host engine)")
            host_rows.append(kernel_a_row(
                torch, mxu_groupby, _cuda, rec,
                host_engine["launches"][qname]["limb_sums"],
                host_engine["parity"][qname],
                f"host_engine {qname} under backend auto: {what}, one "
                "launch"))
        del host_engine
        cluster = phase_cluster(args, torch, qe, tmp, tables["ssb"][0],
                                expected, _cuda, interp, mxu_groupby,
                                fused_groupby, dev["nvidia_smi"])
        mse_cluster = phase_mse_cluster(
            args, torch, tmp, tables["ssb"][0], expected, _cuda, mxu_groupby,
            fused_groupby, mse["p50"], dev["nvidia_smi"])
        admission_tiers = phase_admission_tiers(
            args, torch, tmp, tables["ssb"][0], expected, _cuda, mxu_groupby,
            fused_groupby, dev["nvidia_smi"])
        operations = phase_operations(
            args, torch, tmp, tables["ssb"][0], expected, _cuda, mxu_groupby,
            fused_groupby, dev["nvidia_smi"])
        batch_ingest = phase_batch_ingest(
            args, torch, tmp, batch_inputs, _cuda, mxu_groupby,
            fused_groupby, dev["nvidia_smi"])
        soak_out = phase_soak(torch, _cuda, mxu_groupby, fused_groupby,
                              dev["nvidia_smi"])
        parity.update(soak_out["parity"])
        mesh_out = phase_mesh(args, torch, qe, tables, formats_dirs,
                              expected, _cuda, mxu_groupby, fused_groupby,
                              dev["nvidia_smi"])
        parity.update(mesh_out["parity"])
        phase_doctor(dev["nvidia_smi"], doctor_report)
        planes, gid, G = mse["agg_recs"][0]
        parity["limb_sums/mse_agg_inputs/family"] = check_equal(
            torch, f"limb_sums mse_agg inputs, family of {planes.shape[0]}",
            mxu_groupby.limb_sums(planes, gid, G),
            mxu_groupby.limb_sums_plain(planes, gid, G))

        # the main path's own kernel inputs, one call per segment (per
        # family) and query, for the parity over every query's inputs and
        # the kernel timings
        recorded = {}
        for qname, owner, fn, calls_want in (
                ("q2", fused_groupby, "fused_limb_sums", len(segments)),
                ("q9", fused_groupby, "fused_limb_sums", len(segments)),
                ("q2_unfused", mxu_groupby, "limb_sums", len(segments)),
                ("flagship", mxu_groupby, "limb_sums", len(segments)),
                ("q2_family", mxu_groupby, "limb_sums", 1),
                ("flagship_family", mxu_groupby, "limb_sums", 1),
                ("q4", mxu_groupby, "limb_sums", 1),
                *((q, mxu_groupby, "limb_sums", FAMILY_LAUNCHES[q])
                  for q in MATRIX_QUERIES),
                *((q, mxu_groupby, "limb_sums", 1) for q in MV_QUERIES),
                *((q, mxu_groupby, "limb_sums", 1) for q in TRANSFORM_QUERIES)):
            with recording(owner, fn) as calls:
                qe.execute_sql(QUERIES[qname])
            if len(calls) != calls_want:
                raise AssertionError(f"{qname}: {len(calls)} calls of {fn}")
            recorded[qname] = calls
        for qname in ("q2", "q9"):
            for k, (fp, planes_in, scal, G, n) in enumerate(recorded[qname]):
                parity[f"fused_limb_sums/{qname}_plan/segment{k}"] = check_equal(
                    torch, f"fused_limb_sums {qname} plan, segment {k}",
                    fused_groupby.fused_limb_sums(fp, planes_in, scal, G, n),
                    fused_groupby.fused_limb_sums_plain(fp, planes_in, scal, G, n))
        for qname in ("q2_unfused", "flagship"):
            for k, (planes, gid, G) in enumerate(recorded[qname]):
                parity[f"limb_sums/{qname}_inputs/segment{k}"] = check_equal(
                    torch, f"limb_sums {qname} inputs, segment {k}",
                    mxu_groupby.limb_sums(planes, gid, G),
                    mxu_groupby.limb_sums_plain(planes, gid, G))
        for qname in (("q2_family", "flagship_family", "q4") + MV_QUERIES
                      + TRANSFORM_QUERIES):
            planes, gid, G = recorded[qname][0]
            parity[f"limb_sums/{qname}_inputs/family"] = check_equal(
                torch, f"limb_sums {qname} inputs, family of "
                f"{planes.shape[0]}", mxu_groupby.limb_sums(planes, gid, G),
                mxu_groupby.limb_sums_plain(planes, gid, G))
        for qname in MATRIX_QUERIES:
            for label, (planes, gid, G) in zip(PASS_LABELS[qname],
                                               recorded[qname]):
                parity[f"limb_sums/{qname}_inputs/{label}"] = check_equal(
                    torch, f"limb_sums {qname} inputs, {label}",
                    mxu_groupby.limb_sums(planes, gid, G),
                    mxu_groupby.limb_sums_plain(planes, gid, G))
        # the realtime queries' launches: kernel A over the family (or the
        # committed segment), kernel A or B over the consuming snapshot;
        # the index queries': kernel A over the family of star-tree views
        # or of events / vecs segments; each with the live rows of the
        # segments its dispatch covers
        rt_recorded, rt_live = {}, {}
        for qname in RT_KERNEL_QUERIES + INDEX_KERNEL_QUERIES:
            with dispatch_rows(qe.executor) as rows, \
                    recording(mxu_groupby, "limb_sums", rows) as a_calls, \
                    recording(fused_groupby, "fused_limb_sums",
                              rows) as b_calls:
                qe.execute_sql(QUERIES[qname])
            made = {"limb_sums": len(a_calls), "fused_limb_sums": len(b_calls)}
            if made != {k: per_query[qname][k] for k in made}:
                raise AssertionError(
                    f"{qname}: the recording run made {made} calls, the main "
                    f"path {per_query[qname]} launches")
            rt_recorded[qname] = ([("limb_sums", r) for r, _ in a_calls]
                                  + [("fused_limb_sums", r)
                                     for r, _ in b_calls])
            rt_live[qname] = [live for _, live in a_calls + b_calls]
            for (name, rec), live in zip(rt_recorded[qname], rt_live[qname]):
                S = (rec[0].shape[0] if name == "limb_sums"
                     and rec[0].dim() == 3 else 1)
                masked = (fused_live(rec[2], rec[4])
                          if name == "fused_limb_sums" else live[0])
                if len(live) != S or masked != live[0]:
                    raise AssertionError(f"{qname}: a {name} launch over {S} "
                                         f"members masking {masked} rows, "
                                         f"its dispatch's segments {live}")
            for k, (name, rec) in enumerate(rt_recorded[qname]):
                label = f"{name}/{qname}_inputs/launch{k}"
                if name == "limb_sums":
                    got = mxu_groupby.limb_sums(*rec)
                    ref = mxu_groupby.limb_sums_plain(*rec)
                else:
                    got = fused_groupby.fused_limb_sums(*rec)
                    ref = fused_groupby.fused_limb_sums_plain(*rec)
                parity[label] = check_equal(torch, label, got, ref)
        emit({"phase": "parity", "max_abs_err": parity,
              "tolerance": "element-equal int64"})
        phase_geometry(torch, _cuda, mxu_groupby, fused_groupby, recorded)

        # -- times ----------------------------------------------------------
        p50, quartiles, slow, docs, full_gc = {}, {}, set(), {}, {}
        for qname, sql in QUERIES.items():
            if qname in HOST_HELD:
                continue  # rows and dispatches held in `queries`
            gen2 = gc.get_stats()[2]["collections"]
            ts = []
            while len(ts) < (1 if qname in slow else args.iters):
                t0 = time.perf_counter()
                docs[qname] = qe.execute_sql(sql).total_docs
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
                if ts[0] > SLOW_QUERY_MS:
                    slow.add(qname)
            p50[qname] = float(np.median(ts))
            quartiles[qname] = [float(q) for q in np.percentile(ts, [25, 75])]
            if gc.get_stats()[2]["collections"] > gen2:
                full_gc[qname] = gc.get_stats()[2]["collections"] - gen2
        p50.update(mse["p50"])
        quartiles.update(mse["quartiles"])
        docs.update(mse["docs"])
        slow |= mse["slow"]
        emit({"phase": "times", "card": dev["nvidia_smi"],
              "query_p50_ms": p50, "query_p25_p75_ms": quartiles,
              "rows_per_s": {k: docs[k] / (v / 1e3) for k, v in p50.items()},
              "iters": args.iters, "iters_1": sorted(slow),
              "left_out": list(HOST_HELD),
              "full_collections_during": full_gc})
        phase_layers(torch, qe, min(args.iters, LAYERS_ITERS),
                     dev["nvidia_smi"], slow)
        phase_profile(torch, qe, dev["nvidia_smi"])
        phase_chain(torch, qe, interp, dev["nvidia_smi"])
        phase_oom(torch, qe, expected, dev["nvidia_smi"])
        del qe
        torch.cuda.empty_cache()
        kernels = []
        for qname in ("q2_unfused", "flagship"):
            kernels.append(kernel_a_row(
                torch, mxu_groupby, _cuda, recorded[qname],
                per_query[qname]["limb_sums"],
                parity[f"limb_sums/{qname}_inputs/segment0"],
                f"{qname}: the main path's planes of the {len(segments)} "
                "segments, in turn"))
        for qname in ("q2", "q9"):
            kernels.append(kernel_b_row(
                torch, fused_groupby, _cuda, recorded[qname],
                per_query[qname]["fused_limb_sums"],
                parity[f"fused_limb_sums/{qname}_plan/segment0"],
                f"{qname}: the main path's raw planes of the {len(segments)} "
                "segments, in turn"))
        for qname in ("q2_family", "q4") + MV_QUERIES + TRANSFORM_QUERIES:
            S = recorded[qname][0][0].shape[0]
            kernels.append(kernel_a_row(
                torch, mxu_groupby, _cuda, recorded[qname],
                per_query[qname]["limb_sums"],
                parity[f"limb_sums/{qname}_inputs/family"],
                f"{qname}: the main path's planes of the family of {S} "
                "segments, one launch"))
        # the count passes of the matrix-shaped aggregations, pass by pass:
        # each is launched once a query
        for qname in MATRIX_QUERIES:
            for label, rec in zip(PASS_LABELS[qname], recorded[qname]):
                S = rec[0].shape[0]
                kernels.append(kernel_a_row(
                    torch, mxu_groupby, _cuda, [rec], 1,
                    parity[f"limb_sums/{qname}_inputs/{label}"],
                    f"{qname} {label}: the main path's planes of the family "
                    f"of {S} segments, one launch"))
        # the timeseries engine's fetches: kernel A over the family of the
        # 4 `ssbt` segments, one launch a query
        for qname, rec in timeseries["recs"].items():
            _, start, end, step = TS_QUERIES[qname]
            kernels.append(kernel_a_row(
                torch, mxu_groupby, _cuda, rec,
                timeseries["launches"][qname]["limb_sums"],
                timeseries["parity"][qname],
                f"timeseries {qname}: the fetch's GROUP BY of the "
                f"{step // DAY_MS}-day bucket of lo_orderdate (and the "
                f"tags) over the family of {len(segments)} `{TIME_TABLE}` "
                "segments, one launch"))
        del timeseries
        kernels += host_rows
        # a coalesced group's launch: one for the Q queries' S * Q members
        for q, rec in group_inputs.items():
            kernels.append(kernel_a_row(
                torch, mxu_groupby, _cuda, [rec], 1,
                parity[f"limb_sums/q2_family_group{q}_inputs"],
                f"q2_family coalesced: {q} queries over the family of "
                f"{len(segments)} segments ({rec[0].shape[0]} members), "
                "one launch"))
        del group_inputs
        # kernel A through the cluster: each server's family of 2
        kernels.append(kernel_a_row(
            torch, mxu_groupby, _cuda, cluster["q2_family"],
            cluster["launches"], cluster["err"],
            f"q2_family through the cluster: each of {CLUSTER_SERVERS} "
            "servers' family of its segments, one launch a server"))
        # the flight recorder's sampled runs through the cluster
        fr = cluster["flight_recorder"]
        kernels.append(kernel_a_row(
            torch, mxu_groupby, _cuda, fr["a_recs"], fr["a_launches"],
            fr["a_err"], f"flight_recorder q2_family, head-sampled through "
            f"the cluster: each of {CLUSTER_SERVERS} servers' family of its "
            "segments, one launch a server"))
        kernels.append(kernel_b_row(
            torch, fused_groupby, _cuda, fr["b_recs"], fr["b_launches"],
            fr["b_err"], "flight_recorder q2, head-sampled through the "
            "cluster: a segment a launch on its server"))
        del cluster, fr
        # the cluster multi-stage engine's leaves: kernel A over each
        # server's family of 2 (mse_agg), kernel B a segment (mse_agg_solo)
        kernels.append(kernel_a_row(
            torch, mxu_groupby, _cuda, mse_cluster["a_recs"],
            mse_cluster["a_launches"], mse_cluster["a_err"],
            f"mse_agg through the cluster MSE: the leaf partial aggregate "
            f"of each of {CLUSTER_SERVERS} servers over its family of "
            "segments, one launch a server"))
        kernels.append(kernel_b_row(
            torch, fused_groupby, _cuda, mse_cluster["b_recs"],
            mse_cluster["b_launches"], mse_cluster["b_err"],
            "mse_agg_solo through the cluster MSE: the leaf partial "
            "aggregate with SET segmentBatch = false, a segment a launch "
            "on its server"))
        del mse_cluster
        # phase admission_tiers: kernel A over each tiered server's family
        # of 2 (cold segments warmed, a segment fetched again, a repaired
        # one), on the hedged duplicate's replica and in mse_agg's leaves
        # over warmed cold segments; kernel B a warmed segment
        at = admission_tiers["recs"]
        for label, note in (
                ("cold", "q2_family through a tiered cluster, each server's "
                 "cold segment warmed by the first query: its family of 2"),
                ("refetch", "q2_family after an eviction pass, the demoted "
                 "segment fetched again onto fresh planes: each server's "
                 "family of 2"),
                ("repaired", "q2_family after a storage.fetch corruption "
                 "and its repair: each server's family of 2"),
                ("hedged", "q2_family hedged at 20 ms past a 250 ms primary: "
                 "the duplicate on the other replica, a family of 4"),
                ("mse_agg", "mse_agg through the cluster MSE, each leaf "
                 "warming a cold segment: each server's family of 2")):
            launches = (at["hedged_launches"] if label == "hedged"
                        else len(at[label]))
            kernels.append(kernel_a_row(
                torch, mxu_groupby, _cuda, at[label], launches,
                admission_tiers["parity"][label],
                f"admission_tiers {label}: {note}, one launch a family"))
        kernels.append(kernel_b_row(
            torch, fused_groupby, _cuda, at["q2_warmed"],
            len(at["q2_warmed"]), admission_tiers["parity"]["q2_warmed"],
            "admission_tiers q2 (SET segmentBatch = false) over the "
            "prefetched tiered segments, a segment a launch"))
        del admission_tiers, at
        # phase operations: kernel A over each server's family of 2 through
        # POST /query/sql, over the rebalance destination's family after
        # the moves and over the families the lineage swap left; kernel B
        # a segment for q2 over REST and on the swap's lone segments
        op_recs, op_n = operations["recs"], operations["launches"]
        for label, key, name, note in (
                ("rest_q2_family", "rest_q2_family", "limb_sums",
                 "q2_family through POST /query/sql: each of "
                 f"{CLUSTER_SERVERS} card servers' family of 2, one launch "
                 "a server"),
                ("rest_q2", "rest_q2", "fused_limb_sums",
                 "q2 (SET segmentBatch = false) through POST /query/sql: a "
                 "segment a launch on its server"),
                ("moved", "moved", "limb_sums",
                 "q2_family through REST after the rebalance and the drain: "
                 "the joining destination's family of 2 and the other "
                 "server's, one launch a server"),
                ("lineage", "lineage", "limb_sums",
                 "q2_family through REST after the lineage swap: the family "
                 "of 2 of the server the swap left whole"),
                ("lineage_b", "lineage", "fused_limb_sums",
                 "q2_family through REST after the lineage swap: a segment "
                 "a launch on the servers routing one (the renamed copy's "
                 "and the old owner's)")):
            if not op_recs[label]:
                continue
            row = kernel_a_row if name == "limb_sums" else kernel_b_row
            owner = mxu_groupby if name == "limb_sums" else fused_groupby
            kernels.append(row(
                torch, owner, _cuda, op_recs[label], op_n[key][name],
                operations["parity"][label], f"operations {note}"))
        del operations, op_recs
        # phase batch_ingest: kernel A over each card server's family of 2
        # pushed segments (the same inputs through the broker and the HTTP
        # client) and over the sink's family of 2; kernel B a segment
        bi_recs, bi_n = batch_ingest["recs"], batch_ingest["launches"]
        for label, name, note in (
                ("q2_family", "limb_sums",
                 "q2_family over the batch job's tar-pushed segments (one "
                 "through s3://): each of 2 card servers' family of 2, one "
                 "launch a server; the client's run over HTTP made the "
                 "same launches"),
                ("q2", "fused_limb_sums",
                 "q2 (SET segmentBatch = false) over the batch job's "
                 "segments: a segment a launch on its server"),
                ("sink_q2_family", "limb_sums",
                 "q2_family over the StreamingSegmentWriter's 2 segments "
                 "on one server: its family of 2, one launch"),
                ("merged_q2_family", None,
                 "q2_family over the minion's MergeRollupTask output (the "
                 "sink's 2 segments concatenated, 2^18 rows): a lone "
                 "segment, one launch"),
                ("purged_q2_family", None,
                 "q2_family over the PurgeTask's output (the merged segment "
                 "less its rows matching SINK_PURGE, its mask on the card): "
                 "a lone segment, one launch")):
            rec, live = bi_recs[label], None
            if name is None:  # the minion's lone segment: the kernel it took
                name, rec, rows = rec
                live = [rows]
            n_launched = bi_n[label][name]
            err = batch_ingest["parity"][label]
            note = f"batch_ingest {note}"
            if name == "limb_sums":
                kernels.append(kernel_a_row(torch, mxu_groupby, _cuda, rec,
                                            n_launched, err, note, live))
            else:
                kernels.append(kernel_b_row(torch, fused_groupby, _cuda, rec,
                                            n_launched, err, note))
        del batch_ingest, bi_recs
        # phase soak: kernel A (and B where it ran) over the sql suite's
        # fuzz table and the qps suite's servers' families, timed after it
        kernels += soak_out["rows"]
        del soak_out
        # phase mesh: kernel B at each row shard's offset, kernel A once a
        # dp shard of the family
        kernels += mesh_out["rows"]
        del mesh_out
        # the multi-stage leaf partial aggregate's launch of kernel A
        kernels.append(kernel_a_row(
            torch, mxu_groupby, _cuda, mse["agg_recs"], mse["agg_launches"],
            parity["limb_sums/mse_agg_inputs/family"],
            f"mse_agg: the leaf partial aggregate's planes of the family of "
            f"{mse['agg_recs'][0][0].shape[0]} segments, one launch"))
        # the realtime queries' kernel inputs, one row per launch: each row
        # stands for the main path's launches of its kernel in the query
        # over the recorded launches of it (asserted equal above, so 1)
        for qname, recs in rt_recorded.items():
            for k, ((name, rec), live) in enumerate(zip(recs, rt_live[qname])):
                label = f"{name}/{qname}_inputs/launch{k}"
                launches = per_query[qname][name] // sum(
                    n == name for n, _ in recs)
                note = (f"{qname}: the main path's planes of {len(live)} "
                        f"segment(s), one launch")
                if name == "limb_sums":
                    kernels.append(kernel_a_row(
                        torch, mxu_groupby, _cuda, [rec], launches,
                        parity[label], note, live))
                else:
                    kernels.append(kernel_b_row(
                        torch, fused_groupby, _cuda, [rec], launches,
                        parity[label], note))
        # the ingest phase's launches: kernel A over the families of the
        # segments the managers committed (and of their consuming
        # snapshots), kernel A or B over a lone segment or snapshot
        for qname, (recs, counted) in ingest.items():
            for k, (name, rec, live, err) in enumerate(recs):
                launches = counted[name] // sum(n == name for n, *_ in recs)
                note = (f"ingest {qname}: the main path's planes of "
                        f"{len(live)} segment(s) of a realtime manager, one "
                        "launch")
                if name == "limb_sums":
                    kernels.append(kernel_a_row(
                        torch, mxu_groupby, _cuda, [rec], launches, err,
                        note, live))
                else:
                    kernels.append(kernel_b_row(
                        torch, fused_groupby, _cuda, [rec], launches, err,
                        note))
        del ingest
        # the segment formats' launches: kernel A over the family of the 4
        # compressed, schema-evolved `ssbz` segments, kernel B a segment
        for qname, (name, recs) in formats["recs"].items():
            launches = formats["launches"][qname][name]
            err = max(v for k, v in formats["parity"].items()
                      if k.startswith(f"{name}/{qname}_inputs/"))
            note = (f"segment_formats {qname}: the main path's planes of "
                    f"the {FORMATS_SEGMENTS} `{FORMATS_TABLE}` segments "
                    "(decompressed, virtual columns)")
            if name == "limb_sums":
                kernels.append(kernel_a_row(
                    torch, mxu_groupby, _cuda, recs, launches, err,
                    note + ", one launch"))
            else:
                kernels.append(kernel_b_row(
                    torch, fused_groupby, _cuda, recs, launches, err,
                    note + ", in turn"))
        del formats
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(dev["nvidia_smi"], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
